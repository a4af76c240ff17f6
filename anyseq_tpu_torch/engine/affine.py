"""Gotoh affine-gap row-scan DP in plain torch: the plain version of the
affine wavefront kernels (K5 score sweep, K5p with predecessor codes).

The port of the JAX package's ``engine/xla_affine.py``. With T[i][j] =
max(diag + sub, F[i][j] [, 0]), the horizontal gap matrix has the closed
form

    E[i][j] = max_{k < j} (T[i][k] + go + (j - k) * ge)   (and the boundary)

because reopening from an E-derived H never beats continuing the run
(go <= 0), so E is one ``torch.cummax`` per row; F depends only on the
previous row. int32 max-plus is exact, so the result is bit-identical to
the cell recurrence that the kernel runs.

Predecessor codes are 4 bits a cell: PH in bits 0-1 (the linear codes,
priority diag > E > F), PE in bit 2 and PF in bit 3 (1 = the run extends
the one to its left / above, 0 = opened here). Row i of an (m, n) code
matrix is ``ceil(n / 8)`` int32 words, the code of cell (i, j) in bits
[4*(j % 8), 4*(j % 8) + 4) of word j // 8; only the affine walk (K6)
reads it.
"""
from __future__ import annotations

import torch

from anyseq_tpu_torch.core.types import (
    NEG,
    PRED_GAP_Q,
    PRED_GAP_S,
    PRED_NO_GAP,
    PRED_NONE,
    SCORE_MIN,
    AffineScoring,
    Mode,
)

CODES4_PER_WORD = 8


def pack_codes4(codes: torch.Tensor) -> torch.Tensor:
    """(..., n) 4-bit codes -> (..., ceil(n/8)) int32 words."""
    n = codes.shape[-1]
    nw = -(-n // CODES4_PER_WORD)
    c = torch.nn.functional.pad(codes.to(torch.int64),
                                (0, nw * CODES4_PER_WORD - n))
    c = c.reshape(*codes.shape[:-1], nw, CODES4_PER_WORD)
    shifts = 4 * torch.arange(CODES4_PER_WORD, dtype=torch.int64,
                              device=codes.device)
    w = (c << shifts).sum(-1)
    # the words are 32-bit patterns: wrap them into int32's range
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def unpack_codes4(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes4`: (..., nw) int32 -> (..., n) uint8."""
    shifts = 4 * torch.arange(CODES4_PER_WORD, dtype=torch.int64,
                              device=words.device)
    w = words.to(torch.int64) & 0xFFFFFFFF
    c = (w.unsqueeze(-1) >> shifts) & 15
    return c.reshape(*words.shape[:-1], -1)[..., :n].to(torch.uint8)


def _col_bound(mode: Mode, sc: AffineScoring, i: int) -> int:
    """H[i][-1]; i = -1 is the corner, 0."""
    if mode is Mode.GLOBAL and i >= 0:
        return sc.gap_open + (i + 1) * sc.gap_extend
    return 0


def affine_row(H_prev, F_prev, dsub_no_diag, diag, col_i, jge, local: bool,
               sc: AffineScoring, cole_i=None):
    """One Gotoh row over the last axis. ``diag`` is H[i-1][j-1] and
    ``dsub_no_diag`` the substitution scores; ``col_i`` is H[i][-1], a
    (..., 1) tensor, and ``cole_i`` E[i][-1] likewise, or None for the
    closed-form boundary (E[i][-1] = NEG + go - ge, which yields the same
    row). Returns (H, E, F, dsub)."""
    go, ge = sc.gap_open, sc.gap_extend
    F = torch.maximum(H_prev + (go + ge), F_prev + ge)
    dsub = diag + dsub_no_diag
    T = torch.maximum(dsub, F)
    if local:
        T = T.clamp_min(0)
    cm = torch.cummax(T - jge, -1).values
    shifted = torch.cat([torch.full_like(cm[..., :1], NEG), cm[..., :-1]], -1)
    run = go + torch.maximum(shifted, col_i + ge)
    if cole_i is not None:
        # a run entering from the left: E[i][j] >= E[i][-1] + (j + 1) * ge
        run = torch.maximum(run, cole_i + ge)
    E = jge + run
    H = torch.maximum(T, E)
    return H, E, F, dsub


def pred_codes4(H, E, F, dsub, H_prev, h_left, sc: AffineScoring):
    """The 4-bit codes of a row: PH by diag > E > F (PRED_NONE for a
    clamped local cell), PE / PF 1 where the run extends."""
    go_ge = sc.gap_open + sc.gap_extend
    ph = torch.where(
        H == dsub, PRED_NO_GAP,
        torch.where(H == E, PRED_GAP_Q,
                    torch.where(H == F, PRED_GAP_S, PRED_NONE)))
    pe = (E != h_left + go_ge).to(ph.dtype)
    pf = (F != H_prev + go_ge).to(ph.dtype)
    return ph + 4 * pe + 8 * pf


def top_row_affine(mode: Mode, sc: AffineScoring, n: int, start_gap: bool,
                   device):
    """The closed-form top boundary: H[-1][0..n) and F[-1][0..n)."""
    go, ge = sc.gap_open, sc.gap_extend
    jj = torch.arange(n, dtype=torch.int32, device=device)
    if mode is Mode.GLOBAL:
        H = (0 if start_gap else go) + (jj + 1) * ge
    else:
        H = torch.zeros_like(jj)
    return H, torch.full_like(jj, NEG)


def left_col_affine(mode: Mode, sc: AffineScoring, i0: int, h: int,
                    start_gap: bool, device):
    """The closed-form left boundary of rows [i0, i0 + h): the corner
    H[i0-1][-1] (an int), the column H[i0..i0+h)[-1] and the column
    E[i0..i0+h)[-1] (no run enters from the left: NEG + go - ge, so that
    E[i][0] = go + max(NEG, H[i][-1] + ge) as in :func:`affine_row`)."""
    go, ge = sc.gap_open, sc.gap_extend
    rows = torch.arange(i0, i0 + h, dtype=torch.int32, device=device)
    cole = torch.full_like(rows, NEG + go - ge)
    if mode is not Mode.GLOBAL:
        return 0, torch.zeros_like(rows), cole
    if start_gap:
        return NEG, torch.full_like(rows, NEG), cole
    return _col_bound(mode, sc, i0 - 1), go + (rows + 1) * ge, cole


def _band(q, s, row, rowf, corner, col, cole, mode: Mode, sc: AffineScoring,
          emit_preds: bool):
    """Relax the h = len(q) rows below the top row `row` = H[i0-1][0..n)
    and `rowf` = F[i0-1][0..n), with the corner H[i0-1][-1] and the left
    columns `col` = H[i0..i0+h)[-1] and `cole` = E[i0..i0+h)[-1]. Row
    indices of the outputs count from the top of the band."""
    h, n = int(q.shape[0]), int(s.shape[0])
    dev = s.device
    local = mode is Mode.LOCAL
    jge = torch.arange(n, dtype=torch.int32, device=dev) * sc.gap_extend
    s32 = s.to(torch.int32)
    q32 = q.to(torch.int32)
    col = col.to(torch.int32)
    cole = cole.to(torch.int32)
    match, mismatch = (torch.tensor(x, dtype=torch.int32, device=dev)
                       for x in (sc.match, sc.mismatch))
    corner = torch.as_tensor(corner, dtype=torch.int32, device=dev).reshape(1)
    diag0 = torch.cat([corner, col[:-1]])      # H[i-1][-1]
    H = row.to(torch.int32)
    F = rowf.to(torch.int32)
    last_col = torch.empty(h, dtype=torch.int32, device=dev)
    last_col_e = torch.empty(h, dtype=torch.int32, device=dev)
    best = torch.tensor([SCORE_MIN, -1, -1], dtype=torch.int32, device=dev)
    preds = (torch.empty((h, -(-n // CODES4_PER_WORD)), dtype=torch.int32,
                         device=dev) if emit_preds else None)
    for i in range(h):
        col_i = col[i:i + 1]
        diag = torch.cat([diag0[i:i + 1], H[:-1]])
        sub = torch.where(s32 == q32[i], match, mismatch)
        H_prev = H
        H, E, F, dsub = affine_row(H_prev, F, sub, diag, col_i, jge, local,
                                   sc, cole[i:i + 1])
        if emit_preds:
            h_left = torch.cat([col_i, H[:-1]])
            preds[i] = pack_codes4(pred_codes4(H, E, F, dsub, H_prev, h_left,
                                               sc))
        last_col[i] = H[n - 1]
        last_col_e[i] = E[n - 1]
        rarg = torch.argmax(H)            # first maximum of the row
        rmax = H[rarg]
        best = torch.where(
            rmax > best[0],
            torch.stack([rmax, rmax.new_full((), i), rarg.to(torch.int32)]),
            best,
        )
    outs = {"last_row": H, "last_row_f": F, "last_col": last_col,
            "last_col_e": last_col_e, "best": best}
    if emit_preds:
        outs["preds"] = preds
    return outs


def _sweep(q, s, mode: Mode, sc: AffineScoring, start_gap: bool,
           emit_col_e: bool, emit_preds: bool):
    """The whole DP: the band of all m rows under the closed-form
    boundary."""
    dev = s.device
    outs = _band(q, s, *top_row_affine(mode, sc, int(s.shape[0]), start_gap,
                                       dev),
                 *left_col_affine(mode, sc, 0, int(q.shape[0]), start_gap,
                                  dev),
                 mode, sc, emit_preds)
    del outs["last_row_f"]
    if not emit_col_e:
        del outs["last_col_e"]
    return outs


def score_band_affine(q_band, s, row_in, rowf_in, corner, col_in, cole_in,
                      mode: Mode, sc: AffineScoring):
    """One band of rows [i0, i0 + h) of the Gotoh DP from an explicit
    boundary: the plain version of the affine band kernel (K8 affine).

    As ``linmem.score_band``, plus rowf_in: (n,) F[i0-1][0..n) and
    cole_in: (h,) E[i0..i0+h)[-1] (E[i][0] = max(E[i][-1] + ge, H[i][-1]
    + go + ge)). A Myers-Miller ``start_gap`` band is a matter of these
    inputs (:func:`top_row_affine`, :func:`left_col_affine`). Returns
    last_row, last_row_f (F[i0+h-1][0..n)), last_col, last_col_e
    (E[i0..i0+h)[n-1]) and the band-local best.
    """
    return _band(q_band, s, row_in, rowf_in, corner, col_in, cole_in,
                 Mode.parse(mode), sc, emit_preds=False)


def score_rows_affine(q, s, mode: Mode, sc: AffineScoring,
                      start_gap: bool = False, emit_col_e: bool = False):
    """The whole Gotoh DP in linear memory: the outputs of
    ``linmem.score_rows`` (``last_row``, ``last_col``, ``best``), and with
    ``emit_col_e`` also ``last_col_e`` = E[0..m)[n-1].

    start_gap (GLOBAL only): the alignment enters the top boundary row
    inside a horizontal gap run whose gap_open the caller paid -- the top
    row drops gap_open, and the corner and the left column are
    unreachable (NEG). The Myers-Miller construction's crossing state."""
    mode = Mode.parse(mode)
    if start_gap and mode is not Mode.GLOBAL:
        raise ValueError("start_gap is a GLOBAL-mode option")
    return _sweep(q, s, mode, sc, start_gap, emit_col_e, emit_preds=False)


def score_rows_affine_with_preds(q, s, mode: Mode, sc: AffineScoring):
    """:func:`score_rows_affine` plus ``preds``: (m, ceil(n/8)) int32
    words of 4-bit codes (:func:`pack_codes4`)."""
    return _sweep(q, s, Mode.parse(mode), sc, False, False, emit_preds=True)
