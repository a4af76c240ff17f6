"""K1/K2 and K5/K5p wrappers: the single-pair DP sweep, linear or affine,
chosen by the scoring's type, as one band of the warp strip cores
(``csrc/band.cu`` anyseq_sweep, ``csrc/band_affine.cu``
anyseq_sweep_affine: K8's kernels at a strip width the card's width rule
chooses per launch) from the closed-form boundary of ``linmem.top_row`` /
``left_col`` (``affine.top_row_affine`` / ``left_col_affine``), which the
kernels compute, or, score only at K8's own width, read from those
tensors. Score only (K1, K5), or with each cell's code (K2, K5p: the
cores' ``OUT_CODES`` mode, at the widths that have codes).

:func:`score` returns the output dict of ``engine.linmem.score_rows``
(``last_row``, ``last_col``, ``best``; with ``emit_preds`` also ``preds``,
the packed codes of ``linmem.pack_codes`` or, affine,
``affine.pack_codes4``; affine with ``emit_col_e`` also ``last_col_e``).
On a CPU tensor it runs the plain version (:data:`plain`,
:data:`plain_preds`, :data:`plain_affine`, :data:`plain_affine_preds`);
on a CUDA tensor it launches the kernel. A score-only sweep of more than
``band.M_MAX`` query rows runs as a chain of bands
(``band.score_pair_chained``) on either device, as the JAX package's
``band.score_pair`` does; :func:`launch` and :func:`launch_affine` sweep
in one piece at any height.
"""
from __future__ import annotations

import torch

from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
from anyseq_tpu_torch.engine import affine, linmem
from anyseq_tpu_torch.kernels import _build, band
from anyseq_tpu_torch.kernels._sweep import (
    MODE_CODE,
    check_pair,
    reduce_best,
    strips_of,
)

plain = linmem.score_rows
plain_preds = linmem.score_rows_with_preds
plain_affine = affine.score_rows_affine
plain_affine_preds = affine.score_rows_affine_with_preds


def score(q, s, mode: Mode, sc: LinearScoring | AffineScoring,
          emit_preds: bool = False, start_gap: bool = False,
          emit_col_e: bool = False):
    """DP sweep of query q against subject s (1-D uint8 tensors).
    ``start_gap`` and ``emit_col_e`` are affine options (see
    ``affine.score_rows_affine``); ``start_gap`` runs without preds."""
    mode = Mode.parse(mode)
    check_pair(q, s)
    is_affine = isinstance(sc, AffineScoring)
    if not is_affine and (start_gap or emit_col_e):
        raise ValueError("start_gap and emit_col_e need AffineScoring")
    if start_gap and (emit_preds or mode is not Mode.GLOBAL):
        raise ValueError("start_gap is a GLOBAL score-only option")
    if q.shape[0] > band.M_MAX and not emit_preds:
        outs = band.score_pair_chained(q, s, mode, sc, start_gap=start_gap)
        if is_affine and not emit_col_e:
            del outs["last_col_e"]
        return outs
    if q.device.type == "cpu":
        if is_affine:
            if emit_preds:
                return plain_affine_preds(q, s, mode, sc)
            return plain_affine(q, s, mode, sc, start_gap, emit_col_e)
        return (plain_preds if emit_preds else plain)(q, s, mode, sc)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if is_affine:
        return launch_affine(_build.library(), q, s, mode, sc, emit_preds,
                             start_gap, emit_col_e)
    return launch(_build.library(), q, s, mode, sc, emit_preds)


def _codes(m: int, n: int, width: int, per_word: int, dev):
    """The (m, ceil(n / per_word)) code words a K2 / K5p launch at `width`
    columns a lane writes: a lane's segment of a row is stored only where
    it holds a column below n, so the last word of each row is zeroed
    where no segment reaches its end."""
    words = -(-n // per_word)
    codes = torch.empty((m, words), dtype=torch.int32, device=dev)
    if -(-n // width) * width < words * per_word:
        codes[:, -1] = 0
    return codes


def launch(lib, q, s, mode: Mode, sc: LinearScoring, emit_preds: bool,
           width: int = 0, grid: int = 0):
    """Launch K1 (score only) or K2 (with codes) of `lib` on q and s,
    wherever they lie: the whole sweep as one band of the warp strip core
    (``csrc/band.cu`` anyseq_sweep) from the closed-form boundary, which
    the kernel computes, or (K1 at K8's own width) reads from its
    tensors; at `width` columns a lane (0: the width rule's,
    ``anyseq_sweep_width``), `grid` > 0 capping its warps."""
    m, n = int(q.shape[0]), int(s.shape[0])
    dev, code = q.device, MODE_CODE[mode]
    width = width or lib.anyseq_sweep_width(m, n, code, int(emit_preds))
    edges = ()
    if width == band.LANE_COLS and not emit_preds:
        edges = (linmem.top_row(mode, sc, n, dev),
                 linmem.left_col(mode, sc, 0, m, dev)[1])
    row, col = (t.data_ptr() for t in edges) if edges else (None, None)
    strips = strips_of(n, width)
    i32 = {"dtype": torch.int32, "device": dev}
    ticket_flags = torch.zeros(1 + strips, **i32)
    bcols = torch.empty(max(strips - 1, 1) * m, **i32)
    last_row = torch.empty(n, **i32)
    last_col = torch.empty(m, **i32)
    bests = torch.empty((strips, 3), **i32)
    preds = (_codes(m, n, width, linmem.CODES_PER_WORD, dev) if emit_preds
             else None)
    err = lib.anyseq_sweep(
        q.data_ptr(), m, s.data_ptr(), n, sc.match, sc.mismatch, sc.gap,
        code, width, row, col, grid, ticket_flags.data_ptr(),
        bcols.data_ptr(), ticket_flags.data_ptr() + 4, last_row.data_ptr(),
        last_col.data_ptr(), bests.data_ptr(),
        preds.data_ptr() if emit_preds else None,
        preds.shape[1] if emit_preds else 0, _build.stream(dev),
    )
    _build.check(err, "wavefront")
    _build.launches["wavefront_preds" if emit_preds
                    else "wavefront_score"] += 1
    outs = {"last_row": last_row, "last_col": last_col,
            "best": reduce_best(bests)}
    if emit_preds:
        outs["preds"] = preds
    return outs


def launch_affine(lib, q, s, mode: Mode, sc: AffineScoring, emit_preds: bool,
                  start_gap: bool, emit_col_e: bool, width: int = 0,
                  grid: int = 0):
    """Launch K5 (score only) or K5p (with codes) of `lib` on q and s,
    wherever they lie: the whole sweep as one band of the affine warp
    strip core (``csrc/band_affine.cu`` anyseq_sweep_affine) from the
    closed-form boundary, the Myers-Miller one under `start_gap` (score
    only), which the kernel computes, or (K5 at K8 affine's own width)
    reads from its tensors; at `width` columns a lane (0: the width
    rule's, ``anyseq_sweep_affine_width``), `grid` > 0 capping its
    warps."""
    m, n = int(q.shape[0]), int(s.shape[0])
    dev, code = q.device, MODE_CODE[mode]
    width = width or lib.anyseq_sweep_affine_width(m, n, code,
                                                   int(emit_preds))
    edges = ()
    if width == band.AFFINE_LANE_COLS and not emit_preds:
        edges = (*affine.top_row_affine(mode, sc, n, start_gap, dev),
                 *affine.left_col_affine(mode, sc, 0, m, start_gap, dev)[1:])
    ptrs = [t.data_ptr() for t in edges] if edges else [None] * 4
    strips = strips_of(n, width)
    i32 = {"dtype": torch.int32, "device": dev}
    ticket_flags = torch.zeros(1 + strips, **i32)
    bcols = torch.empty(max(strips - 1, 1) * m, **i32)
    bcols_e = torch.empty(max(strips - 1, 1) * m, **i32)
    last_row = torch.empty(n, **i32)
    rowf_out = torch.empty(n, **i32)
    last_col = torch.empty(m, **i32)
    last_col_e = torch.empty(m, **i32)
    bests = torch.empty((strips, 3), **i32)
    preds = (_codes(m, n, width, affine.CODES4_PER_WORD, dev) if emit_preds
             else None)
    err = lib.anyseq_sweep_affine(
        q.data_ptr(), m, s.data_ptr(), n, sc.match, sc.mismatch, sc.gap_open,
        sc.gap_extend, code, int(start_gap), width, *ptrs, grid,
        ticket_flags.data_ptr(), bcols.data_ptr(), bcols_e.data_ptr(),
        ticket_flags.data_ptr() + 4, last_row.data_ptr(),
        rowf_out.data_ptr(), last_col.data_ptr(), last_col_e.data_ptr(),
        bests.data_ptr(), preds.data_ptr() if emit_preds else None,
        preds.shape[1] if emit_preds else 0, _build.stream(dev),
    )
    _build.check(err, "wavefront_affine")
    _build.launches["wavefront_affine_preds" if emit_preds
                    else "wavefront_affine_score"] += 1
    outs = {"last_row": last_row, "last_col": last_col,
            "best": reduce_best(bests)}
    if emit_col_e:
        outs["last_col_e"] = last_col_e
    if emit_preds:
        outs["preds"] = preds
    return outs
