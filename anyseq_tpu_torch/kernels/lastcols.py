"""K4 wrapper: last columns of a batch of GLOBAL problems
(``csrc/lastcols.cu``), and the hb_sum split merge of a Hirschberg level.

On a CPU tensor :func:`last_cols` runs the plain version (:func:`plain`,
``engine.batch.last_cols_batch`` in the kernel's layout); on a CUDA tensor
it launches the kernel.
"""
from __future__ import annotations

import torch

from anyseq_tpu_torch.core.types import LinearScoring
from anyseq_tpu_torch.engine import batch
from anyseq_tpu_torch.kernels import _build
from anyseq_tpu_torch.kernels.wavefront import STRIP


def plain(q, s, ms, ns, sc: LinearScoring) -> torch.Tensor:
    """The plain version of the kernel, on any device, in its layout."""
    cols = batch.last_cols_batch(q, s, ms, ns, sc).T
    rows = torch.arange(q.shape[1], device=q.device)[None, :]
    ms = ms.to(device=q.device, dtype=torch.int64)[:, None]
    return torch.where(rows < ms, cols, 0).contiguous()


def _check(q, s, ms, ns) -> None:
    B = q.shape[0]
    for name, t in (("q", q), ("s", s)):
        if t.dtype != torch.uint8 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, L) uint8 tensor")
    if s.shape[0] != B or ms.shape != (B,) or ns.shape != (B,):
        raise ValueError("batch sizes disagree")
    if q.device != s.device:
        raise ValueError("q and s must be on one device")


def last_cols(q, s, ms, ns, sc: LinearScoring) -> torch.Tensor:
    """(B, M) int32: [b, i] = H_b[i][ns[b] - 1] for i < ms[b], 0 beyond.

    q: (B, M) uint8, s: (B, N) uint8, ms/ns: (B,) lengths >= 1."""
    _check(q, s, ms, ns)
    if q.device.type == "cpu":
        return plain(q, s, ms, ns, sc)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return launch(_build.library(), q, s, ms, ns, sc)


def launch(lib, q, s, ms, ns, sc: LinearScoring) -> torch.Tensor:
    """Launch the kernel of `lib`, wherever the tensors lie."""
    B, M = q.shape
    dev = q.device
    i32 = {"dtype": torch.int32, "device": dev}
    ms = ms.to(**i32).contiguous()
    ns = ns.to(**i32).contiguous()
    strips = torch.where(ms > 0, (ns + STRIP - 1) // STRIP, 0)
    strip_start = torch.zeros(B + 1, **i32)
    strip_start[1:] = torch.cumsum(strips, 0)
    total = int(strip_start[-1])
    cols = torch.zeros((B, M), **i32)
    ticket = torch.zeros(1, **i32)
    flags = torch.zeros(max(total, 1), **i32)
    bcols = torch.empty(max(total, 1) * M, **i32)
    err = lib.anyseq_lastcols(
        q.data_ptr(), q.stride(0), s.data_ptr(), s.stride(0), ms.data_ptr(),
        ns.data_ptr(), strip_start.data_ptr(), B, total, sc.match,
        sc.mismatch, sc.gap, ticket.data_ptr(), bcols.data_ptr(), M,
        flags.data_ptr(), cols.data_ptr(), M, _build.stream(dev),
    )
    _build.check(err, "lastcols")
    _build.launches["lastcols"] += 1
    return cols


def hb_merge(L, R, hs, mids, rights, g: int):
    """hb_sum of one Hirschberg level, P parts at once, in int64.

    L, R: (P, Mb) last columns of the left halves and of the reversed
    right halves; hs, mids, rights: (P,) part heights, left and right
    half widths. F(k) = L[k] + R[h-k-2] for k in [-1, h-1], where the
    edges k = -1 and k = h-1 take the all-gap score of the empty half.
    Returns (k, F(k)) per part, ties to the smallest k."""
    P, Mb = L.shape
    dev = L.device
    L = L.to(torch.int64)
    R = R.to(torch.int64)
    h = hs.to(device=dev, dtype=torch.int64)[:, None]
    x = torch.arange(Mb + 1, device=dev)[None, :]          # x = k + 1
    F = (L.gather(1, (x - 1).clamp(0, Mb - 1).expand(P, -1))
         + R.gather(1, (h - 1 - x).clamp(0, Mb - 1)))
    last = (h - 1).clamp_min(0)
    F = torch.where(x == 0, mids.to(dev)[:, None] * g + R.gather(1, last), F)
    F = torch.where(x == h, L.gather(1, last) + rights.to(dev)[:, None] * g, F)
    F = torch.where(x > h, torch.iinfo(torch.int64).min, F)
    best = F.max(1).values
    k = torch.where(F == best[:, None], x, Mb + 1).min(1).values - 1
    return k, best
