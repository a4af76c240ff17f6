"""K7 wrapper: the batch sweep, one thread per problem
(``csrc/swarm.cu``).

:func:`score_pairs_swarm` returns the output dict of
``engine.batch.swarm_batch`` (``last_rows``, ``last_cols``, ``best``; with
``emit_preds`` also ``preds``, the 2-bit codes of ``linmem.pack_codes`` or,
affine, the 4-bit codes of ``affine.pack_codes4``).
On a CPU tensor it runs the plain version (:data:`plain`); on a CUDA
tensor it launches the kernel.
"""
from __future__ import annotations

import torch

from anyseq_tpu_torch.core.types import AffineScoring, Mode
from anyseq_tpu_torch.engine import batch
from anyseq_tpu_torch.engine.affine import CODES4_PER_WORD
from anyseq_tpu_torch.engine.linmem import CODES_PER_WORD
from anyseq_tpu_torch.kernels import _build
from anyseq_tpu_torch.kernels._sweep import MODE_CODE

plain = batch.swarm_batch

# bytes of subject one thread loads at a time (csrc/swarm.cu): the kernel
# reads subject rows padded to a multiple of this
SUBJECT_LOAD = 16


def _check(q, s, ms, ns, sgaps) -> None:
    B = q.shape[0]
    for name, t in (("q", q), ("s", s)):
        if t.dtype != torch.uint8 or t.dim() != 2 or t.stride(1) != 1:
            raise ValueError(f"{name} must be a (B, L) uint8 tensor")
    if s.shape[0] != B or ms.shape != (B,) or ns.shape != (B,):
        raise ValueError("batch sizes disagree")
    if sgaps is not None and sgaps.shape != (B,):
        raise ValueError("sgaps must be (B,)")
    devices = {t.device for t in (q, s, ms, ns) + (() if sgaps is None
                                                   else (sgaps,))}
    if len(devices) != 1:
        raise ValueError("all tensors must be on one device")


def score_pairs_swarm(q, s, ms, ns, mode: Mode, sc, sgaps=None,
                      need_pos: bool = True, emit_preds: bool = False):
    """Sweep B problems, one per thread. q: (B, M) uint8, s: (B, N)
    uint8, ms/ns: (B,) lengths >= 1 (at most M / N), sgaps: (B,) bool
    start-gap flags of affine GLOBAL problems. Returns the dict of
    ``batch.swarm_batch``."""
    mode = Mode.parse(mode)
    _check(q, s, ms, ns, sgaps)
    if q.device.type == "cpu":
        return plain(q, s, ms, ns, mode, sc, sgaps, need_pos, emit_preds)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return launch(_build.library(), q, s, ms, ns, mode, sc, sgaps, need_pos,
                  emit_preds)


def launch(lib, q, s, ms, ns, mode: Mode, sc, sgaps=None,
           need_pos: bool = True, emit_preds: bool = False):
    """Launch the kernel of `lib`, wherever the tensors lie. Outputs past
    a problem's lengths are never written by the kernel: they keep the 0
    they are allocated with, as the plain version gives."""
    B, M = q.shape
    N = s.shape[1]
    dev = q.device
    i32 = {"dtype": torch.int32, "device": dev}
    pad = -N % SUBJECT_LOAD
    if pad or s.stride(0) % SUBJECT_LOAD or s.data_ptr() % SUBJECT_LOAD:
        s = torch.nn.functional.pad(s, (0, pad)).contiguous()
    ms = ms.to(**i32).contiguous()
    ns = ns.to(**i32).contiguous()
    if sgaps is None:
        sgaps = torch.zeros(B, dtype=torch.bool, device=dev)
    sgaps = sgaps.to(torch.bool).contiguous()
    affine = isinstance(sc, AffineScoring)
    gap, go, ge = ((0, sc.gap_open, sc.gap_extend) if affine
                   else (sc.gap, 0, 0))
    rowbuf = torch.empty((N, B), **i32)
    frow = torch.empty((N, B) if affine else (1,), **i32)
    last_rows = torch.zeros((B, N), **i32)
    last_cols = torch.zeros((B, M), **i32)
    best = torch.empty((B, 3), **i32)
    nw = -(-N // (CODES4_PER_WORD if affine else CODES_PER_WORD))
    preds = torch.zeros((B, M, nw), **i32) if emit_preds else None
    err = lib.anyseq_swarm(
        q.data_ptr(), q.stride(0), s.data_ptr(), s.stride(0), ms.data_ptr(),
        ns.data_ptr(), sgaps.data_ptr(), B, sc.match, sc.mismatch, gap, go,
        ge, int(affine), MODE_CODE[mode], int(need_pos), int(emit_preds),
        rowbuf.data_ptr(), frow.data_ptr(), last_rows.data_ptr(), N,
        last_cols.data_ptr(), M, best.data_ptr(),
        preds.data_ptr() if emit_preds else None, M, nw,
        _build.stream(dev),
    )
    _build.check(err, "swarm")
    _build.launches["swarm_preds" if emit_preds else "swarm_score"] += 1
    outs = {"last_rows": last_rows, "last_cols": last_cols, "best": best}
    if emit_preds:
        outs["preds"] = preds
    return outs
