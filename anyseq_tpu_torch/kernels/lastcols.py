"""K4 and K5L wrappers: last columns of a batch of GLOBAL problems, linear
(``csrc/lastcols.cu``) and affine (``csrc/lastcols_affine.cu``), and the
split merges of a level: hb_sum (Hirschberg) and the Myers-Miller merge.

On a CPU tensor :func:`last_cols` and :func:`last_cols_affine` run the
plain versions (:func:`plain`, ``engine.batch.last_cols_batch``, and
:func:`plain_affine`, ``engine.batch.last_cols_batch_affine``, in the
kernels' layout); on a CUDA tensor they launch the kernels, on the warp
strip cores at one width a launch (the card's level rule, which holds the
boundary columns between strips to 1 / :data:`SCRATCH_SHARE` of the
card's free memory). The problems' lengths may be given on the host (a
list, an array or a CPU tensor), as the level drivers do: the kernels'
strip list is built there and copied to the card once; lengths on the
card are copied back once.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring
from anyseq_tpu_torch.engine import batch
from anyseq_tpu_torch.kernels import _build
from anyseq_tpu_torch.kernels._sweep import LANES
from anyseq_tpu_torch.utils import profiling

# Columns a lane K4 and K5L sweep at, widest first (csrc/lastcols.cu and
# csrc/lastcols_affine.cu with_width): K4 one row a step, K5L one row at
# 16 and two rows a step at 8 and 4.
WIDTHS = (32, 16, 8)
AFFINE_WIDTHS = (16, 8, 4)
# The level rule takes a narrower width only where the boundary columns
# it needs fit in 1 / SCRATCH_SHARE of the card's free memory at the call.
SCRATCH_SHARE = 4


class Plan(NamedTuple):
    """One launch of K4 or K5L: its width (columns a lane), its warps, its
    strips, the bytes of its boundary columns and the cap the rule held
    them to."""
    width: int
    warps: int
    strips: int
    scratch_bytes: int
    cap_bytes: int


# the last launch's plan, for the tools that report it
last_plan: Plan | None = None


def plain(q, s, ms, ns, sc: LinearScoring) -> torch.Tensor:
    """The plain version of the kernel, on any device, in its layout."""
    cols = batch.last_cols_batch(q, s, ms, ns, sc).T
    rows = torch.arange(q.shape[1], device=q.device)[None, :]
    ms = ms.to(device=q.device, dtype=torch.int64)[:, None]
    return torch.where(rows < ms, cols, 0).contiguous()


def plain_affine(q, s, ms, ns, sc: AffineScoring, sgaps):
    """The plain version of the affine kernel, on any device, in its
    layout."""
    rows = torch.arange(q.shape[1], device=q.device)[None, :]
    inside = rows < ms.to(device=q.device, dtype=torch.int64)[:, None]
    return tuple(torch.where(inside, c.T, 0).contiguous() for c in
                 batch.last_cols_batch_affine(q, s, ms, ns, sc, sgaps))


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x, dtype=np.int64))


def _host(x) -> np.ndarray:
    """Lengths as a contiguous int32 array on the host (lengths on the
    card are copied back: one synchronisation)."""
    if isinstance(x, torch.Tensor):
        with profiling.wait():
            x = x.detach().to("cpu", torch.int32)
        x = x.numpy()
    return np.ascontiguousarray(x, dtype=np.int32)


def _check(q, s, ms, ns) -> None:
    B = q.shape[0]
    for name, t in (("q", q), ("s", s)):
        if t.dtype != torch.uint8 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, L) uint8 tensor")
    if s.shape[0] != B or len(ms) != B or len(ns) != B:
        raise ValueError("batch sizes disagree")
    if q.device != s.device:
        raise ValueError("q and s must be on one device")


def last_cols(q, s, ms, ns, sc: LinearScoring) -> torch.Tensor:
    """(B, M) int32: [b, i] = H_b[i][ns[b] - 1] for i < ms[b], 0 beyond.

    q: (B, M) uint8, s: (B, N) uint8, ms/ns: (B,) lengths >= 1."""
    _check(q, s, ms, ns)
    if q.device.type == "cpu":
        return plain(q, s, _as_tensor(ms), _as_tensor(ns), sc)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return launch(_build.library(), q, s, ms, ns, sc)


def _cap_bytes(dev) -> int:
    """1 / SCRATCH_SHARE of the memory free for tensors on `dev`: the
    card's free memory and what the caching allocator holds unused (no
    cap off the card)."""
    if dev.type != "cuda":
        return 2**62
    free = torch.cuda.mem_get_info(dev)[0]
    unused = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(
        dev)
    return (free + unused) // SCRATCH_SHARE


def _plan(lib, name: str, ms, ns, rows, cols, value_bytes: int, width: int,
          grid: int, dev):
    """Width, strip list and scratch of one launch of K4 (`name`
    anyseq_lastcols) or K5L (anyseq_lastcols_affine) on problems of
    `rows` x `cols` in the kernel's orientation (ms, ns the caller's
    lengths on the host): (plan, the LevelMeta array on `dev`, boundary
    values). `width` 0 takes the level rule's; `grid` > 0 caps the
    warps."""
    B = len(ms)
    args = (ms.ctypes.data, ns.ctypes.data, B)
    cap = _cap_bytes(dev)
    width = width or getattr(lib, name + "_width")(*args, cap)
    strip = LANES * width
    rows, cols = rows.astype(np.int64), cols.astype(np.int64)
    strips = np.where((rows > 0) & (cols > 0), -(-cols // strip), 0)
    start = np.zeros(B + 1, np.int64)
    np.cumsum(strips, out=start[1:])
    values = np.maximum(strips - 1, 0) * rows
    boff = np.cumsum(values) - values
    meta = torch.from_numpy(np.concatenate([ms, ns, start, boff]).astype(
        np.int64))
    with profiling.wait():      # from pageable memory
        meta = meta.to(dev)
    total, held = int(start[-1]), int(values.sum())
    global last_plan
    last_plan = Plan(width, getattr(lib, name + "_grid")(*args, width, grid),
                     total, held * value_bytes, cap)
    return last_plan, meta, held


def launch(lib, q, s, ms, ns, sc: LinearScoring, width: int = 0,
           grid: int = 0) -> torch.Tensor:
    """Launch K4 of `lib`, wherever the tensors lie, at `width` columns a
    lane (0: the level rule's, ``anyseq_lastcols_width``), `grid` > 0
    capping its warps."""
    B, M = q.shape
    dev = q.device
    i32 = {"dtype": torch.int32, "device": dev}
    ms, ns = _host(ms), _host(ns)
    # K4 sweeps each problem transposed: subject rows, query columns
    plan, meta, held = _plan(lib, "anyseq_lastcols", ms, ns, ns, ms, 4,
                             width, grid, dev)
    cols = torch.zeros((B, M), **i32)
    ticket_flags = torch.zeros(1 + plan.strips, **i32)
    bcols = torch.empty(max(held, 1), **i32)
    err = lib.anyseq_lastcols(
        q.data_ptr(), q.stride(0), s.data_ptr(), s.stride(0),
        ms.ctypes.data, ns.ctypes.data, meta.data_ptr(), B, plan.strips,
        sc.match, sc.mismatch, sc.gap, plan.width, grid,
        ticket_flags.data_ptr(), bcols.data_ptr(), cols.data_ptr(), M,
        _build.stream(dev),
    )
    _build.check(err, "lastcols")
    if plan.strips:
        _build.launches["lastcols"] += 1
    return cols


def last_cols_affine(q, s, ms, ns, sc: AffineScoring, sgaps):
    """((B, M), (B, M)) int32: [b, i] = H_b[i][ns[b] - 1] and
    E_b[i][ns[b] - 1] for i < ms[b], 0 beyond; problem b's top row
    continues a paid gap run where sgaps[b].

    q: (B, M) uint8, s: (B, N) uint8, ms/ns: (B,) lengths >= 1, sgaps:
    (B,) bool."""
    _check(q, s, ms, ns)
    if sgaps.shape != (len(ms),):
        raise ValueError("batch sizes disagree")
    if q.device.type == "cpu":
        return plain_affine(q, s, _as_tensor(ms), _as_tensor(ns), sc, sgaps)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return launch_affine(_build.library(), q, s, ms, ns, sc, sgaps)


def launch_affine(lib, q, s, ms, ns, sc: AffineScoring, sgaps,
                  width: int = 0, grid: int = 0):
    """Launch K5L of `lib`, wherever the tensors lie, at `width` columns a
    lane (0: the level rule's, ``anyseq_lastcols_affine_width``), `grid` >
    0 capping its warps."""
    B, M = q.shape
    dev = q.device
    i32 = {"dtype": torch.int32, "device": dev}
    ms, ns = _host(ms), _host(ns)
    plan, meta, held = _plan(lib, "anyseq_lastcols_affine", ms, ns, ms, ns,
                             8, width, grid, dev)
    sgaps = sgaps.to(device=dev, dtype=torch.bool).contiguous()
    cols = torch.zeros((B, M), **i32)
    cols_e = torch.zeros((B, M), **i32)
    ticket_flags = torch.zeros(1 + plan.strips, **i32)
    bcols = torch.empty(max(held, 1), **i32)
    bcols_e = torch.empty(max(held, 1), **i32)
    err = lib.anyseq_lastcols_affine(
        q.data_ptr(), q.stride(0), s.data_ptr(), s.stride(0),
        ms.ctypes.data, ns.ctypes.data, meta.data_ptr(), sgaps.data_ptr(), B,
        plan.strips, sc.match, sc.mismatch, sc.gap_open, sc.gap_extend,
        plan.width, grid, ticket_flags.data_ptr(), bcols.data_ptr(),
        bcols_e.data_ptr(), cols.data_ptr(), cols_e.data_ptr(), M,
        _build.stream(dev),
    )
    _build.check(err, "lastcols_affine")
    if plan.strips:
        _build.launches["lastcols_affine"] += 1
    return cols, cols_e


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


def mm_merge(HL, EL, HR, ER, hs, mids, rights, sc: AffineScoring, sgaps,
             egaps):
    """The Myers-Miller merge of one level, P parts at once, in int64.

    HL, EL / HR, ER: (P, Mb) H and E last columns of the left halves and
    of the reversed right halves; hs, mids, rights: (P,) part heights,
    left and right half widths; sgaps / egaps: (P,) the parts' start- and
    end-in-gap flags. Over k in [-1, h-1], with x = k + 1:

      type 1 (the cut crossed in state H):  HL[k] + HR[h-2-k]
      type 2 (one gap run spans the cut):   EL[k] + ER[h-2-k] - gap_open

    where the edges k = -1 and k = h-1 take the all-gap score of the empty
    half, without gap_open where the part's own flag says the run is paid.
    Returns (k, crosses_in_gap, score) per part: ties go to the smallest
    k, and type 1 wins equal bests."""
    P, Mb = HL.shape
    dev = HL.device
    go, ge = sc.gap_open, sc.gap_extend
    i64 = torch.int64
    h = hs.to(device=dev, dtype=i64)[:, None]
    x = torch.arange(Mb + 1, device=dev)[None, :]          # x = k + 1
    edge_l = (mids.to(device=dev, dtype=i64) * ge + torch.where(
        sgaps.to(device=dev, dtype=torch.bool), 0, go))[:, None]
    edge_r = (rights.to(device=dev, dtype=i64) * ge + torch.where(
        egaps.to(device=dev, dtype=torch.bool), 0, go))[:, None]
    li = (x - 1).clamp(0, Mb - 1).expand(P, -1)
    ri = (h - 1 - x).clamp(0, Mb - 1)
    best, args = [], []
    for left, right, extra in ((HL, HR, 0), (EL, ER, -go)):
        lv = torch.where(x == 0, edge_l, left.to(i64).gather(1, li))
        rv = torch.where(x == h, edge_r, right.to(i64).gather(1, ri))
        t = torch.where(x > h, torch.iinfo(i64).min // 2, lv + rv + extra)
        top = t.max(1).values
        best.append(top)
        args.append(torch.where(t == top[:, None], x, Mb + 1).min(1).values
                    - 1)
    cross = best[1] > best[0]
    return (torch.where(cross, args[1], args[0]), cross,
            torch.where(cross, best[1], best[0]))
