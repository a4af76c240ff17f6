"""K8 and K8 affine wrappers: one band of rows from an explicit boundary
(``csrc/band.cu``, ``csrc/band_affine.cu``), and the chained sweep that
scores a query of any length one band after another.

The counterpart of the JAX package's ``kernels/band.py`` chained path
(``_score_band_padded`` in boundary mode, ``score_pair_chained``). A
single-pair sweep keeps ``(strips - 1) * m`` ints of boundary columns
between its 1024-column strips; a band keeps ``(strips - 1) * band_rows``,
so a chain of bands scores an m-row query in O(n * band_rows / 1024)
device memory whatever m is. ``kernels.wavefront.score`` sends every
score-only sweep taller than :data:`M_MAX` rows here.

:func:`score_band` returns the output dict of ``linmem.score_band`` (or
``affine.score_band_affine``); on a CPU tensor it runs that plain version
(:data:`plain`, :data:`plain_affine`), on a CUDA tensor it launches the
kernel.
"""
from __future__ import annotations

import torch

from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
from anyseq_tpu_torch.engine import affine, linmem
from anyseq_tpu_torch.kernels import _build
from anyseq_tpu_torch.kernels._sweep import (
    MODE_CODE,
    STRIP,
    check_pair,
    reduce_best,
)

plain = linmem.score_band
plain_affine = affine.score_band_affine

# Tallest query swept in one piece (the JAX package's M_MAX, a TPU memory
# cap: on the H100 one K1 sweep still fits at 1 Mbp and is faster than
# the chain, ROADMAP item 9), and the rows of each band of the chain above
# it (its M_BAND).
M_MAX = 512 * 1024
M_BAND = 256 * 1024


def score_band(q_band, s, row_in, corner: int, col_in, mode: Mode,
               sc: LinearScoring | AffineScoring, rowf_in=None,
               cole_in=None):
    """Rows [i0, i0 + h) of the DP of q against s from the top row
    ``row_in`` (+ ``rowf_in``, affine), the corner H[i0-1][-1] and the
    left column ``col_in`` (+ ``cole_in``, affine); see
    ``linmem.score_band`` and ``affine.score_band_affine``."""
    mode = Mode.parse(mode)
    check_pair(q_band, s)
    is_affine = isinstance(sc, AffineScoring)
    h, n = int(q_band.shape[0]), int(s.shape[0])
    cols = (col_in, cole_in) if is_affine else (col_in,)
    rows = (row_in, rowf_in) if is_affine else (row_in,)
    for t, size in [(c, h) for c in cols] + [(r, n) for r in rows]:
        if (t is None or t.dtype != torch.int32 or t.shape != (size,)
                or t.device != s.device or not t.is_contiguous()):
            raise ValueError("band boundaries must be contiguous int32 "
                             "tensors of the band's height and width, on "
                             "the sequences' device")
    if s.device.type == "cpu":
        if is_affine:
            return plain_affine(q_band, s, row_in, rowf_in, corner, col_in,
                                cole_in, mode, sc)
        return plain(q_band, s, row_in, corner, col_in, mode, sc)
    if s.device.type != "cuda":
        raise ValueError(f"unsupported device {s.device}")
    if is_affine:
        return launch_affine(_build.library(), q_band, s, row_in, rowf_in,
                             corner, col_in, cole_in, mode, sc)
    return launch(_build.library(), q_band, s, row_in, corner, col_in, mode,
                  sc)


def launch(lib, q, s, row_in, corner, col_in, mode: Mode, sc: LinearScoring,
           grid: int = 0):
    """Launch K8 of `lib` on the band, wherever it lies; `grid` > 0 caps
    the CTAs."""
    h, n = int(q.shape[0]), int(s.shape[0])
    strips = -(-n // STRIP)
    i32 = {"dtype": torch.int32, "device": q.device}
    ticket = torch.zeros(1, **i32)
    flags = torch.zeros(strips, **i32)
    bcols = torch.empty(max(strips - 1, 1) * h, **i32)
    row_out = torch.empty(n, **i32)
    last_col = torch.empty(h, **i32)
    bests = torch.empty((strips, 3), **i32)
    err = lib.anyseq_band(
        q.data_ptr(), h, s.data_ptr(), n, sc.match, sc.mismatch, sc.gap,
        MODE_CODE[mode], row_in.data_ptr(), int(corner),
        col_in.data_ptr(), grid, ticket.data_ptr(), bcols.data_ptr(),
        flags.data_ptr(), row_out.data_ptr(), last_col.data_ptr(),
        bests.data_ptr(), _build.stream(q.device),
    )
    _build.check(err, "band")
    _build.launches["band"] += 1
    return {"last_row": row_out, "last_col": last_col,
            "best": reduce_best(bests)}


def launch_affine(lib, q, s, row_in, rowf_in, corner, col_in, cole_in,
                  mode: Mode, sc: AffineScoring, grid: int = 0):
    """Launch K8 affine of `lib` on the band, wherever it lies; `grid` > 0
    caps the CTAs."""
    h, n = int(q.shape[0]), int(s.shape[0])
    strips = -(-n // STRIP)
    i32 = {"dtype": torch.int32, "device": q.device}
    ticket = torch.zeros(1, **i32)
    flags = torch.zeros(strips, **i32)
    bcols = torch.empty(max(strips - 1, 1) * h, **i32)
    bcols_e = torch.empty(max(strips - 1, 1) * h, **i32)
    row_out = torch.empty(n, **i32)
    rowf_out = torch.empty(n, **i32)
    last_col = torch.empty(h, **i32)
    last_col_e = torch.empty(h, **i32)
    bests = torch.empty((strips, 3), **i32)
    err = lib.anyseq_band_affine(
        q.data_ptr(), h, s.data_ptr(), n, sc.match, sc.mismatch, sc.gap_open,
        sc.gap_extend, MODE_CODE[mode], row_in.data_ptr(),
        rowf_in.data_ptr(), int(corner), col_in.data_ptr(),
        cole_in.data_ptr(), grid, ticket.data_ptr(), bcols.data_ptr(),
        bcols_e.data_ptr(), flags.data_ptr(), row_out.data_ptr(),
        rowf_out.data_ptr(), last_col.data_ptr(), last_col_e.data_ptr(),
        bests.data_ptr(), _build.stream(q.device),
    )
    _build.check(err, "band_affine")
    _build.launches["band_affine"] += 1
    return {"last_row": row_out, "last_row_f": rowf_out, "last_col": last_col,
            "last_col_e": last_col_e, "best": reduce_best(bests)}


def score_pair_chained(q, s, mode: Mode, sc: LinearScoring | AffineScoring,
                       band_rows: int | None = None, start_gap: bool = False):
    """Score q against s as a chain of bands of ``band_rows`` rows
    (default :data:`M_BAND`), each band's bottom row (+ affine F row)
    the next one's top row. Returns the outputs of ``linmem.score_rows``
    (affine: with ``last_col_e``), bit-identical to one sweep.

    ``start_gap`` (affine GLOBAL only): the Myers-Miller boundary, which
    changes only the first band's top row and every band's left column
    and corner (``affine.left_col_affine``).
    """
    mode = Mode.parse(mode)
    is_affine = isinstance(sc, AffineScoring)
    if start_gap and not (is_affine and mode is Mode.GLOBAL):
        raise ValueError("start_gap is an affine GLOBAL (Myers-Miller) "
                         "option")
    band_rows = band_rows or M_BAND
    m, n = int(q.shape[0]), int(s.shape[0])
    dev = s.device
    if is_affine:
        row, rowf = affine.top_row_affine(mode, sc, n, start_gap, dev)
    else:
        row = linmem.top_row(mode, sc, n, dev)
    last_cols, last_cols_e, bests = [], [], []
    for i0 in range(0, m, band_rows):
        h = min(band_rows, m - i0)
        if is_affine:
            corner, col, cole = affine.left_col_affine(mode, sc, i0, h,
                                                       start_gap, dev)
            outs = score_band(q[i0:i0 + h], s, row, corner, col, mode, sc,
                              rowf, cole)
            rowf = outs["last_row_f"]
            last_cols_e.append(outs["last_col_e"])
        else:
            corner, col = linmem.left_col(mode, sc, i0, h, dev)
            outs = score_band(q[i0:i0 + h], s, row, corner, col, mode, sc)
        row = outs["last_row"]
        last_cols.append(outs["last_col"])
        bests.append(outs["best"] + torch.tensor([0, i0, 0],
                                                 dtype=torch.int32,
                                                 device=dev))
    # a later band's best takes only if strictly greater, so the earliest
    # band wins ties: argmax returns the first maximum
    bests = torch.stack(bests)
    res = {"last_row": row, "last_col": torch.cat(last_cols),
           "best": bests[torch.argmax(bests[:, 0])]}
    if is_affine:
        res["last_col_e"] = torch.cat(last_cols_e)
    return res
