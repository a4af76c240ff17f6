"""K7 wrapper: the batch sweep (``csrc/swarm.cu``), many independent pairs
in one launch on the warp strip cores: every strip of every problem in one
ticket list, a warp a strip.

:func:`score_pairs_swarm` returns the output dict of
``engine.batch.swarm_batch`` (``last_rows``, ``last_cols``, ``best``; with
``emit_preds`` also ``preds``, the 2-bit codes of ``linmem.pack_codes`` or,
affine, the 4-bit codes of ``affine.pack_codes4``).
On a CPU tensor it runs the plain version (:func:`plain`); on a CUDA
tensor it launches the kernel, at one width a launch (the card's rule,
``anyseq_swarm_plan``, which holds the boundary columns between strips
to ``lastcols.SCRATCH_SHARE``'s share of the card's free memory). The
problems' lengths may be given on the host (a list, an array or a CPU
tensor), as the batch calls do: the strip list is built there and copied
to the card once; lengths on the card are copied back once.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from anyseq_tpu_torch.core.types import AffineScoring, Mode
from anyseq_tpu_torch.engine import batch
from anyseq_tpu_torch.engine.affine import CODES4_PER_WORD
from anyseq_tpu_torch.engine.linmem import CODES_PER_WORD
from anyseq_tpu_torch.kernels import _build, lastcols
from anyseq_tpu_torch.kernels._sweep import LANES, MODE_CODE


# Columns a lane K7 sweeps at, widest first (csrc/swarm.cu with_width):
# linear one row a step, affine one row at 16 and two rows a step below.
# With codes not 12 (a lane's codes of a row would share a word with the
# next lane's) nor 32 (slower than 8 at the batch calls' widest pairs).
WIDTHS = (32, 16, 12, 8)
PREDS_WIDTHS = (16, 8)
AFFINE_WIDTHS = (16, 12, 8, 4)
AFFINE_PREDS_WIDTHS = (16, 8, 4)
# The width rule asks the card for its free memory (the cap on boundary
# columns) only where the narrowest width's boundary columns could take
# more than this: the query cost ~1 ms of host time a launch on an H100
# (PERF.md), more than K7's kernel at ~256 bp.
SMALL_SCRATCH = 64 << 20


class Plan(NamedTuple):
    """One launch of K7: its width (columns a lane), its warps, its strips
    and the bytes of its boundary columns."""
    width: int
    warps: int
    strips: int
    scratch_bytes: int


# the last launch's plan, for the tools that report it
last_plan: Plan | None = None


def widths_of(affine: bool, emit_preds: bool) -> tuple:
    """K7's widths for a scoring and codes."""
    if affine:
        return AFFINE_PREDS_WIDTHS if emit_preds else AFFINE_WIDTHS
    return PREDS_WIDTHS if emit_preds else WIDTHS


def boundary_bytes(ms, ns, affine: bool, emit_preds: bool) -> int:
    """The most bytes of boundary columns K7 can hold for problems of
    lengths ms x ns (scalars or arrays): their strips at K7's narrowest
    width, each but the last handing on a column of H (and E, affine)."""
    strip = LANES * widths_of(affine, emit_preds)[-1]
    ns = np.asarray(ns, np.int64)
    return int(((-(-ns // strip) - 1) * ms).sum()) * (8 if affine else 4)


def _check(q, s, ms, ns, sgaps) -> None:
    B = q.shape[0]
    for name, t in (("q", q), ("s", s)):
        if t.dtype != torch.uint8 or t.dim() != 2 or t.stride(1) != 1:
            raise ValueError(f"{name} must be a (B, L) uint8 tensor")
    if s.shape[0] != B or len(ms) != B or len(ns) != B:
        raise ValueError("batch sizes disagree")
    if sgaps is not None and sgaps.shape != (B,):
        raise ValueError("sgaps must be (B,)")
    if q.device != s.device:
        raise ValueError("q and s must be on one device")


def _ptr(t, offset: int = 0):
    """A tensor's address plus `offset` bytes; null for None."""
    return None if t is None else t.data_ptr() + offset


def plain(q, s, ms, ns, mode: Mode, sc, sgaps=None, need_pos: bool = True,
          emit_preds: bool = False):
    """The plain version of the kernel (``batch.swarm_batch``), on any
    device, the lengths anywhere."""
    return batch.swarm_batch(q, s, lastcols._as_tensor(ms),
                             lastcols._as_tensor(ns), mode, sc, sgaps,
                             need_pos, emit_preds)


def score_pairs_swarm(q, s, ms, ns, mode: Mode, sc, sgaps=None,
                      need_pos: bool = True, emit_preds: bool = False):
    """Sweep B problems. q: (B, M) uint8, s: (B, N) uint8, ms/ns: (B,)
    lengths >= 1 (at most M / N), sgaps: (B,) bool start-gap flags of
    affine GLOBAL problems. Returns the dict of ``batch.swarm_batch``."""
    mode = Mode.parse(mode)
    _check(q, s, ms, ns, sgaps)
    if q.device.type == "cpu":
        return plain(q, s, ms, ns, mode, sc, sgaps, need_pos, emit_preds)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return launch(_build.library(), q, s, ms, ns, mode, sc, sgaps, need_pos,
                  emit_preds)


def launch(lib, q, s, ms, ns, mode: Mode, sc, sgaps=None,
           need_pos: bool = True, emit_preds: bool = False, width: int = 0):
    """Launch the kernel of `lib`, wherever the tensors lie, at `width`
    columns a lane (0: the rule's, ``anyseq_swarm_plan``). Outputs past a
    problem's lengths are never written by the kernel: they keep the 0
    they are allocated with, as the plain version gives."""
    global last_plan
    mode = Mode.parse(mode)
    B, M = q.shape
    N = s.shape[1]
    dev = q.device
    ms, ns = lastcols._host(ms), lastcols._host(ns)
    affine = isinstance(sc, AffineScoring)
    # the strip list (band_sweep.cuh LevelMeta), built on the host in
    # pinned memory, so that its copy does not wait for the stream's
    # earlier work
    meta = torch.empty(4 * B + 1, dtype=torch.int64,
                       pin_memory=dev.type == "cuda")
    plan = np.zeros(4, np.int64)
    args = (ms.ctypes.data, ns.ctypes.data, B, int(affine), MODE_CODE[mode],
            int(emit_preds), width)
    got = lib.anyseq_swarm_plan(*args, 2**62, meta.data_ptr(),
                                plan.ctypes.data)
    if not width and plan[3] > SMALL_SCRATCH:
        got = lib.anyseq_swarm_plan(*args, lastcols._cap_bytes(dev),
                                    meta.data_ptr(), plan.ctypes.data)
    if got <= 0:
        raise ValueError(f"K7 has no width {width} for this scoring and "
                         f"codes: {widths_of(affine, emit_preds)}")
    width = got
    total, held, warps = (int(x) for x in plan[:3])
    last_plan = Plan(width, warps, total, held * (8 if affine else 4))
    meta = meta.to(dev, non_blocking=True)
    if sgaps is not None:
        sgaps = sgaps.to(device=dev, dtype=torch.bool).contiguous()
    gap, go, ge = ((0, sc.gap_open, sc.gap_extend) if affine
                   else (sc.gap, 0, 0))
    i32 = {"dtype": torch.int32, "device": dev}
    nw = -(-N // (CODES4_PER_WORD if affine else CODES_PER_WORD))
    # the ticket counter, the flags and the outputs zeroed at once; the
    # boundary columns (H, then E) and the strips' bests only where a
    # problem has several strips
    sizes = (1 + total, B * N, B * M, 3 * B, B * M * nw if emit_preds else 0)
    ticket_flags, last_rows, last_cols, best, preds = torch.zeros(
        sum(sizes), **i32).split(sizes)
    bcols = torch.empty(held * (2 if affine else 1), **i32) if held else None
    bests = (torch.empty(3 * total, **i32)
             if held and mode is Mode.LOCAL else None)
    err = lib.anyseq_swarm(
        q.data_ptr(), q.stride(0), s.data_ptr(), s.stride(0),
        meta.data_ptr(), _ptr(sgaps), B, total, warps, sc.match,
        sc.mismatch, gap, go, ge, int(affine), MODE_CODE[mode],
        int(need_pos), int(emit_preds), width, ticket_flags.data_ptr(),
        _ptr(bcols), _ptr(bcols if affine else None, 4 * held), _ptr(bests),
        last_rows.data_ptr(), N, last_cols.data_ptr(), M, best.data_ptr(),
        preds.data_ptr() if emit_preds else None, M, nw, _build.stream(dev),
    )
    _build.check(err, "swarm")
    _build.launches["swarm_preds" if emit_preds else "swarm_score"] += 1
    outs = {"last_rows": last_rows.view(B, N),
            "last_cols": last_cols.view(B, M), "best": best.view(B, 3)}
    if emit_preds:
        outs["preds"] = preds.view(B, M, nw)
    return outs
