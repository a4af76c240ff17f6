"""K8 and K8 affine wrappers: one band of rows from an explicit boundary
(``csrc/band.cu``, ``csrc/band_affine.cu``), and the chained sweep that
scores a query of any length one band after another; K10 and K10 affine,
the same band over one rank's stripe of columns with its boundary columns
handed across ranks through a :class:`Halo` (the collective sweep of
``dist/collective.py``).

The counterpart of the JAX package's ``kernels/band.py`` chained path
(``_score_band_padded`` in boundary mode, ``score_pair_chained``). A
single-pair sweep keeps ``(strips - 1) * m`` ints of boundary columns
between its strips; a band keeps ``(strips - 1) * band_rows``
(affine: H and E columns between :data:`AFFINE_STRIP`-column strips), so
a chain of bands scores an m-row query in O(n * band_rows / 512) device
memory whatever m is. ``kernels.wavefront.score`` sends every
score-only sweep taller than :data:`M_MAX` rows here.

:func:`score_band` returns the output dict of ``linmem.score_band`` (or
``affine.score_band_affine``); on a CPU tensor it runs that plain version
(:data:`plain`, :data:`plain_affine`), on a CUDA tensor it launches the
kernel. :func:`score_band_collective` likewise runs
:func:`plain_collective` / :func:`plain_collective_affine` or launches
K10.
"""
from __future__ import annotations

import torch

from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
from anyseq_tpu_torch.engine import affine, linmem
from anyseq_tpu_torch.kernels import _build
from anyseq_tpu_torch.kernels._sweep import (
    LANES,
    MODE_CODE,
    check_pair,
    reduce_best,
    strips_of,
)
from anyseq_tpu_torch.utils import profiling

plain = linmem.score_band
plain_affine = affine.score_band_affine

# Columns a lane of K8 / K10 (csrc/band_sweep.cuh BandGeom: STRIP-column
# strips) and of K8 affine / K10 affine (csrc/band_sweep_affine.cuh
# BandGeom: AFFINE_STRIP), whose scratch and bests the wrappers size.
LANE_COLS = 32
AFFINE_LANE_COLS = 16
STRIP = LANES * LANE_COLS
AFFINE_STRIP = LANES * AFFINE_LANE_COLS
# The columns a lane that K1 and K5, the single-pair score sweeps on the
# same cores, and K2 and K5p, the same sweeps with codes, may sweep at
# (csrc/band.cu, csrc/band_affine.cu with_width), widest first; the width
# rule (anyseq_sweep_width, ..._affine_width) picks one per launch.
WIDTHS = (32, 16, 8)
AFFINE_WIDTHS = (16, 8, 4)
CODE_WIDTHS = (16, 8)
AFFINE_CODE_WIDTHS = (16, 8, 4)

# Tallest query swept in one piece (the JAX package's M_MAX, a TPU memory
# cap: on the H100 one K1 sweep still fits at 1 Mbp and is faster than
# the chain, ROADMAP R2), and the rows of each band of the chain above
# it (its M_BAND).
M_MAX = 512 * 1024
M_BAND = 256 * 1024


def _check_band(q_band, s, rows, cols) -> None:
    check_pair(q_band, s)
    h, n = int(q_band.shape[0]), int(s.shape[0])
    for t, size in [(c, h) for c in cols] + [(r, n) for r in rows]:
        if (t is None or t.dtype != torch.int32 or t.shape != (size,)
                or t.device != s.device or not t.is_contiguous()):
            raise ValueError("band boundaries must be contiguous int32 "
                             "tensors of the band's height and width, on "
                             "the sequences' device")


def score_band(q_band, s, row_in, corner: int, col_in, mode: Mode,
               sc: LinearScoring | AffineScoring, rowf_in=None,
               cole_in=None):
    """Rows [i0, i0 + h) of the DP of q against s from the top row
    ``row_in`` (+ ``rowf_in``, affine), the corner H[i0-1][-1] and the
    left column ``col_in`` (+ ``cole_in``, affine); see
    ``linmem.score_band`` and ``affine.score_band_affine``."""
    mode = Mode.parse(mode)
    is_affine = isinstance(sc, AffineScoring)
    _check_band(q_band, s, (row_in, rowf_in) if is_affine else (row_in,),
                (col_in, cole_in) if is_affine else (col_in,))
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
    the warps (one a strip; 0: the grid `band.cu` chooses)."""
    return _launch("band", lib, q, s, row_in, corner, col_in, mode, sc, None,
                   None, 0, 0, 1, grid)


def launch_affine(lib, q, s, row_in, rowf_in, corner, col_in, cole_in,
                  mode: Mode, sc: AffineScoring, grid: int = 0):
    """Launch K8 affine of `lib` on the band, wherever it lies; `grid` > 0
    caps the warps (one a strip; 0: the grid `band_affine.cu` chooses),
    as for :func:`launch`."""
    return _launch_affine("band_affine", lib, q, s, row_in, rowf_in, corner,
                          col_in, cole_in, mode, sc, None, None, 0, 0, 1,
                          grid)


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
        with profiling.wait():      # from pageable memory
            shift = torch.tensor([0, i0, 0], dtype=torch.int32, device=dev)
        bests.append(outs["best"] + shift)
    # a later band's best takes only if strictly greater, so the earliest
    # band wins ties: argmax returns the first maximum
    bests = torch.stack(bests)
    res = {"last_row": row, "last_col": torch.cat(last_cols),
           "best": bests[torch.argmax(bests[:, 0])]}
    if is_affine:
        res["last_col_e"] = torch.cat(last_cols_e)
    return res


class Halo:
    """The column left of a rank's stripe, H[0..m)[j0 - 1] (and E, affine),
    on that rank's device, which the rank to its left writes band by band
    as it sweeps: ``flags[b]`` counts the rows of band b published so far.
    ``sys``: the producer runs on another card (it writes through peer
    access, and both sides fence system-wide)."""

    def __init__(self, m: int, bands: int, affine: bool, device,
                 producer_device):
        i32 = {"dtype": torch.int32, "device": device}
        self.h = torch.zeros(m, **i32)
        self.e = torch.zeros(m, **i32) if affine else None
        self.flags = torch.zeros(bands, **i32)
        self.sys = torch.device(device) != torch.device(producer_device)

    def tensors(self):
        return [t for t in (self.h, self.e, self.flags) if t is not None]

    # A process edge of the collective sweep (``dist/collective.py``): the
    # columns cross in host memory, one band at a time; no kernel waits
    # on a flag that another process's work must raise.

    def host_stage(self, pinned: bool) -> torch.Tensor:
        """Host memory for this halo's columns at a process edge (pinned
        for a card's copies), laid out band by band: see :meth:`slot`."""
        c = 1 if self.e is None else 2
        return torch.empty(c * self.h.shape[0], dtype=torch.int32,
                           pin_memory=pinned)

    def slot(self, stage: torch.Tensor, i0: int, h: int) -> torch.Tensor:
        """The (1, h) H column of the band at rows [i0, i0 + h) in
        `stage`, or its (2, h) H and E columns (affine): one contiguous
        message."""
        c = 1 if self.e is None else 2
        return stage[c * i0:c * (i0 + h)].view(c, h)

    def fill(self, b: int, i0: int, cols: torch.Tensor) -> None:
        """Band b's columns, received from the process on the left, into
        rows [i0, i0 + h) of h (and e), and its flag raised: on the current
        stream, before the band's K10 launch, which then finds them all
        published."""
        h = cols.shape[1]
        self.h[i0:i0 + h].copy_(cols[0], non_blocking=True)
        if self.e is not None:
            self.e[i0:i0 + h].copy_(cols[1], non_blocking=True)
        self.flags[b:b + 1].fill_(h)

    def read(self, i0: int, cols: torch.Tensor) -> None:
        """The columns that this (staging) halo's producer wrote into rows
        [i0, i0 + h), into `cols` (a :meth:`slot` of host memory): on the
        current stream, after the band's launch; the copy has landed once
        an event recorded after it has."""
        h = cols.shape[1]
        cols[0].copy_(self.h[i0:i0 + h], non_blocking=True)
        if self.e is not None:
            cols[1].copy_(self.e[i0:i0 + h], non_blocking=True)


def _ptr(t, offset: int = 0):
    """The address of int32 element `offset` of t, None for no tensor."""
    return None if t is None else t.data_ptr() + 4 * offset


def _publish(halo_out, outs, b: int, i0: int, h: int) -> None:
    """The plain versions' hand-off: the band's last columns into rows
    [i0, i0 + h) of the right rank's halo, and its flag raised."""
    if halo_out is None:
        return
    halo_out.h[i0:i0 + h] = outs["last_col"]
    if halo_out.e is not None:
        halo_out.e[i0:i0 + h] = outs["last_col_e"]
    halo_out.flags[b] = h


def plain_collective(q, s, row_in, corner, col_in, mode: Mode,
                     sc: LinearScoring, halo_in, halo_out, b: int, i0: int):
    """The plain version of K10: band b (rows [i0, i0 + h)) of one rank's
    stripe, as ``linmem.score_band``, with the left column (and, for
    b > 0, the corner: row i0 - 1 of the same column) taken from
    `halo_in` where given, and the last column written to `halo_out`."""
    h = int(q.shape[0])
    if halo_in is not None:
        col_in = halo_in.h[i0:i0 + h]
        if b > 0:
            corner = halo_in.h[i0 - 1]
    outs = plain(q, s, row_in, corner, col_in, mode, sc)
    _publish(halo_out, outs, b, i0, h)
    return outs


def plain_collective_affine(q, s, row_in, rowf_in, corner, col_in, cole_in,
                            mode: Mode, sc: AffineScoring, halo_in, halo_out,
                            b: int, i0: int):
    """The plain version of K10 affine: as :func:`plain_collective`, with
    the F row and the E column of ``affine.score_band_affine``."""
    h = int(q.shape[0])
    if halo_in is not None:
        col_in, cole_in = halo_in.h[i0:i0 + h], halo_in.e[i0:i0 + h]
        if b > 0:
            corner = halo_in.h[i0 - 1]
    outs = plain_affine(q, s, row_in, rowf_in, corner, col_in, cole_in, mode,
                        sc)
    _publish(halo_out, outs, b, i0, h)
    return outs


def score_band_collective(q_band, s, row_in, corner, col_in, mode: Mode,
                          sc: LinearScoring | AffineScoring, halo_in,
                          halo_out, b: int, i0: int, rowf_in=None,
                          cole_in=None, share: int = 1):
    """Band b (rows [i0, i0 + h)) of one rank's stripe of the collective
    sweep: :func:`score_band`, whose left column (+ E column) and, for
    b > 0, corner come from `halo_in` (None for the first rank, which
    takes `corner` and `col_in`), and whose last columns also go to
    `halo_out` (None for the last rank). On a CUDA tensor it launches K10
    on the current device and stream, which must not wait on a launch
    enqueued after it; `share` launches of the sweep run on this card at
    once and split its resident warps."""
    mode = Mode.parse(mode)
    is_affine = isinstance(sc, AffineScoring)
    cols = () if halo_in is not None else (
        (col_in, cole_in) if is_affine else (col_in,))
    _check_band(q_band, s, (row_in, rowf_in) if is_affine else (row_in,),
                cols)
    if s.device.type == "cpu":
        if is_affine:
            return plain_collective_affine(q_band, s, row_in, rowf_in, corner,
                                           col_in, cole_in, mode, sc, halo_in,
                                           halo_out, b, i0)
        return plain_collective(q_band, s, row_in, corner, col_in, mode, sc,
                                halo_in, halo_out, b, i0)
    if s.device.type != "cuda":
        raise ValueError(f"unsupported device {s.device}")
    if is_affine:
        return launch_collective_affine(
            _build.library(), q_band, s, row_in, rowf_in, corner, col_in,
            cole_in, mode, sc, halo_in, halo_out, b, i0, share=share)
    return launch_collective(_build.library(), q_band, s, row_in, corner,
                             col_in, mode, sc, halo_in, halo_out, b, i0,
                             share=share)


def _halo_args(halo_in, halo_out, b: int, i0: int, affine: bool):
    """The halo pointers of a K10 launch, in the C entry's order: corner
    pointer, inputs (H, [E,] flag), outputs (H, [E,] flag), sys_in,
    sys_out."""
    def side(halo):
        if halo is None:
            return (None,) * (3 if affine else 2)
        cols = (halo.h, halo.e) if affine else (halo.h,)
        return tuple(_ptr(c, i0) for c in cols) + (_ptr(halo.flags, b),)

    corner = _ptr(halo_in.h, i0 - 1) if halo_in is not None and b > 0 else None
    return (corner, side(halo_in), side(halo_out),
            int(getattr(halo_in, "sys", False)),
            int(getattr(halo_out, "sys", False)))


def launch_collective(lib, q, s, row_in, corner, col_in, mode: Mode,
                      sc: LinearScoring, halo_in, halo_out, b: int, i0: int,
                      share: int = 1, grid: int = 0):
    """Launch K10 of `lib` on band b of one rank's stripe (the arguments
    of :func:`plain_collective`), wherever it lies; `grid` > 0 caps the
    warps, as for :func:`launch`."""
    return _launch("band_collective", lib, q, s, row_in, corner, col_in,
                   mode, sc, halo_in, halo_out, b, i0, share, grid)


def launch_collective_affine(lib, q, s, row_in, rowf_in, corner, col_in,
                             cole_in, mode: Mode, sc: AffineScoring, halo_in,
                             halo_out, b: int, i0: int, share: int = 1,
                             grid: int = 0):
    """Launch K10 affine of `lib` on band b of one rank's stripe (the
    arguments of :func:`plain_collective_affine`), wherever it lies;
    `grid` > 0 caps the warps, as for :func:`launch_affine`."""
    return _launch_affine("band_collective_affine", lib, q, s, row_in,
                          rowf_in, corner, col_in, cole_in, mode, sc, halo_in,
                          halo_out, b, i0, share, grid)


def _launch(name, lib, q, s, row_in, corner, col_in, mode: Mode,
            sc: LinearScoring, halo_in, halo_out, b: int, i0: int, share: int,
            grid: int):
    """K8 (no halos) or K10: the C entry anyseq_band, counted as `name`."""
    h, n = int(q.shape[0]), int(s.shape[0])
    strips = strips_of(n, LANE_COLS)
    i32 = {"dtype": torch.int32, "device": q.device}
    ticket = torch.zeros(1, **i32)
    flags = torch.zeros(strips, **i32)
    bcols = torch.empty(max(strips - 1, 1) * h, **i32)
    row_out = torch.empty(n, **i32)
    last_col = torch.empty(h, **i32)
    bests = torch.empty((strips, 3), **i32)
    from_halo = halo_in is not None
    corner_ptr, inp, out, sys_in, sys_out = _halo_args(halo_in, halo_out, b,
                                                       i0, False)
    err = lib.anyseq_band(
        q.data_ptr(), h, s.data_ptr(), n, sc.match, sc.mismatch, sc.gap,
        MODE_CODE[mode], row_in.data_ptr(),
        0 if from_halo and b > 0 else int(corner), corner_ptr,
        None if from_halo else col_in.data_ptr(),
        *inp, *out, sys_in, sys_out, share, grid, ticket.data_ptr(),
        bcols.data_ptr(), flags.data_ptr(), row_out.data_ptr(),
        last_col.data_ptr(), bests.data_ptr(), _build.stream(q.device),
    )
    _build.check(err, name)
    _build.launches[name] += 1
    return {"last_row": row_out, "last_col": last_col,
            "best": reduce_best(bests)}


def _launch_affine(name, lib, q, s, row_in, rowf_in, corner, col_in, cole_in,
                   mode: Mode, sc: AffineScoring, halo_in, halo_out, b: int,
                   i0: int, share: int, grid: int):
    """K8 affine (no halos) or K10 affine: the C entry anyseq_band_affine,
    counted as `name`."""
    h, n = int(q.shape[0]), int(s.shape[0])
    strips = strips_of(n, AFFINE_LANE_COLS)
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
    from_halo = halo_in is not None
    corner_ptr, inp, out, sys_in, sys_out = _halo_args(halo_in, halo_out, b,
                                                       i0, True)
    err = lib.anyseq_band_affine(
        q.data_ptr(), h, s.data_ptr(), n, sc.match, sc.mismatch, sc.gap_open,
        sc.gap_extend, MODE_CODE[mode], row_in.data_ptr(),
        rowf_in.data_ptr(), 0 if from_halo and b > 0 else int(corner),
        corner_ptr, None if from_halo else col_in.data_ptr(),
        None if from_halo else cole_in.data_ptr(), *inp, *out, sys_in,
        sys_out, share, grid, ticket.data_ptr(), bcols.data_ptr(),
        bcols_e.data_ptr(), flags.data_ptr(), row_out.data_ptr(),
        rowf_out.data_ptr(), last_col.data_ptr(), last_col_e.data_ptr(),
        bests.data_ptr(), _build.stream(q.device),
    )
    _build.check(err, name)
    _build.launches[name] += 1
    return {"last_row": row_out, "last_row_f": rowf_out, "last_col": last_col,
            "last_col_e": last_col_e, "best": reduce_best(bests)}
