"""Linear-memory row-scan DP in plain torch: the plain version of the
wavefront kernels (K1 score sweep, K2 with predecessor codes).

Each DP row is one vector operation, by the max-plus prefix-scan identity
of the JAX package's ``engine/xla_linmem.py``: for a gap penalty g <= 0,

    H[i][j] = max(C[j], H[i][j-1] + g),   C[j] = max(diag + sub, up + g [, 0])

has the closed form

    H[i][j] = j*g + max(cummax_{k<=j}(C[k] - k*g), H[i][-1] + g)

so the sequential j-loop becomes one ``torch.cummax``. int32 max-plus is
exact, so the result is bit-identical to the cell recurrence.

Predecessor codes use a packed layout that the traceback walk (K3) reads:
row i of an (m, n) code matrix is ``ceil(n / 16)`` int32 words, the code of
cell (i, j) in bits [2*(j % 16), 2*(j % 16) + 2) of word j // 16.
"""
from __future__ import annotations

import torch

from anyseq_tpu_torch.core.types import (
    PRED_GAP_Q,
    PRED_GAP_S,
    PRED_NO_GAP,
    PRED_NONE,
    SCORE_MIN,
    LinearScoring,
    Mode,
)
from anyseq_tpu_torch.utils import profiling

CODES_PER_WORD = 16


def _init(mode: Mode, sc: LinearScoring, x):
    """Boundary score H[x][-1] (or H[-1][x]); x = -1 is the corner."""
    if mode is Mode.GLOBAL:
        return (x + 1) * sc.gap
    return x * 0


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """(..., n) predecessor codes -> (..., ceil(n/16)) int32 words."""
    n = codes.shape[-1]
    nw = -(-n // CODES_PER_WORD)
    c = torch.nn.functional.pad(codes.to(torch.int64),
                                (0, nw * CODES_PER_WORD - n))
    c = c.reshape(*codes.shape[:-1], nw, CODES_PER_WORD)
    shifts = 2 * torch.arange(CODES_PER_WORD, dtype=torch.int64,
                              device=codes.device)
    w = (c << shifts).sum(-1)
    # the words are 32-bit patterns: wrap them into int32's range
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def unpack_codes(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: (..., nw) int32 -> (..., n) uint8."""
    shifts = 2 * torch.arange(CODES_PER_WORD, dtype=torch.int64,
                              device=words.device)
    w = words.to(torch.int64) & 0xFFFFFFFF
    c = (w.unsqueeze(-1) >> shifts) & 3
    return c.reshape(*words.shape[:-1], -1)[..., :n].to(torch.uint8)


def top_row(mode: Mode, sc: LinearScoring, n: int, device):
    """The closed-form top boundary row H[-1][0..n)."""
    return _init(mode, sc, torch.arange(n, dtype=torch.int32, device=device))


def left_col(mode: Mode, sc: LinearScoring, i0: int, h: int, device):
    """The closed-form left boundary of rows [i0, i0 + h): the corner
    H[i0-1][-1] (an int) and the column H[i0..i0+h)[-1]."""
    rows = torch.arange(i0, i0 + h, dtype=torch.int32, device=device)
    return _init(mode, sc, i0 - 1), _init(mode, sc, rows)


def _band(q, s, row, corner, col, mode: Mode, sc: LinearScoring,
          emit_preds: bool):
    """Relax the h = len(q) rows below the top row `row` = H[i0-1][0..n),
    with the corner H[i0-1][-1] and the left column `col` = H[i0..i0+h)[-1].
    Row indices of the outputs count from the top of the band."""
    h, n = int(q.shape[0]), int(s.shape[0])
    dev = s.device
    g = sc.gap
    local = mode is Mode.LOCAL
    jg = torch.arange(n, dtype=torch.int32, device=dev) * g
    s32 = s.to(torch.int32)
    q32 = q.to(torch.int32)
    col = col.to(torch.int32)
    match, mismatch = (torch.tensor(x, dtype=torch.int32, device=dev)
                       for x in (sc.match, sc.mismatch))
    # diag0[i] = H[i-1][-1] and colg[i] = H[i][-1] + g, as 1-element views
    corner = torch.as_tensor(corner, dtype=torch.int32, device=dev).reshape(1)
    diag0 = torch.cat([corner, col[:-1]])
    colg = col + g
    prev = row.to(torch.int32)
    last_col = torch.empty(h, dtype=torch.int32, device=dev)
    best = torch.tensor([SCORE_MIN, -1, -1], dtype=torch.int32, device=dev)
    preds = (torch.empty((h, -(-n // CODES_PER_WORD)), dtype=torch.int32,
                         device=dev) if emit_preds else None)
    for i in range(h):
        diag = torch.cat([diag0[i:i + 1], prev[:-1]])
        dsub = diag + torch.where(s32 == q32[i], match, mismatch)
        cand = torch.maximum(dsub, prev + g)
        if local:
            cand = cand.clamp_min(0)
        run = torch.maximum(torch.cummax(cand - jg, 0).values,
                            colg[i:i + 1])
        row = run + jg
        if emit_preds:
            left = torch.cat([col[i:i + 1], row[:-1]])
            code = torch.where(
                row == dsub, PRED_NO_GAP,
                torch.where(row == left + g, PRED_GAP_Q,
                            torch.where(row == prev + g, PRED_GAP_S,
                                        PRED_NONE)))
            preds[i] = pack_codes(code)
        last_col[i] = row[n - 1]
        rarg = torch.argmax(row)          # first maximum of the row
        rmax = row[rarg]
        best = torch.where(
            rmax > best[0],
            torch.stack([rmax, rmax.new_full((), i), rarg.to(torch.int32)]),
            best,
        )
        prev = row
    outs = {"last_row": prev, "last_col": last_col, "best": best}
    if emit_preds:
        outs["preds"] = preds
    return outs


def _sweep(q, s, mode: Mode, sc: LinearScoring, emit_preds: bool):
    """The whole DP: the band of all m rows under the closed-form
    boundary."""
    dev = s.device
    return _band(q, s, top_row(mode, sc, int(s.shape[0]), dev),
                 *left_col(mode, sc, 0, int(q.shape[0]), dev), mode, sc,
                 emit_preds)


def score_band(q_band, s, row_in, corner, col_in, mode: Mode,
               sc: LinearScoring):
    """One band of rows [i0, i0 + h) of the DP from an explicit boundary:
    the plain version of the band kernel (K8).

    q_band: (h,) uint8 query rows of the band; s: (n,) uint8 subject;
    row_in: (n,) int32 top row H[i0-1][0..n); corner: H[i0-1][-1];
    col_in: (h,) int32 left column H[i0..i0+h)[-1]. Returns int32 tensors:
      last_row: (n,) H[i0+h-1][0..n)
      last_col: (h,) H[i0..i0+h)[n-1]
      best:     (3,) (score, i, j), the band's first maximum, i counted
                from the top of the band.
    """
    return _band(q_band, s, row_in, corner, col_in, Mode.parse(mode), sc,
                 emit_preds=False)


def score_rows(q, s, mode: Mode, sc: LinearScoring):
    """The whole DP in linear memory.

    q: (m,) uint8 query, s: (n,) uint8 subject, both on one device.
    Returns a dict of int32 tensors on that device:
      last_row: (n,) H[m-1][0..n)
      last_col: (m,) H[0..m)[n-1]
      best:     (3,) (score, i, j), the first maximum in row-major order.
    """
    return _sweep(q, s, Mode.parse(mode), sc, emit_preds=False)


def score_rows_with_preds(q, s, mode: Mode, sc: LinearScoring):
    """:func:`score_rows` plus ``preds``: (m, ceil(n/16)) int32 packed
    predecessor codes, recovered from the final row values in the
    priority diag > gap_q > gap_s (PRED_NONE marks clamped local cells)."""
    return _sweep(q, s, Mode.parse(mode), sc, emit_preds=True)


def extract_end(outs, m: int, n: int, mode: Mode) -> torch.Tensor:
    """Final score and end cell as an int32 tensor (score, i, j) on the
    outputs' device (mirror of ``xla_linmem.extract_score_from_outputs``).

    Semiglobal candidates include the boundary cells (m-1, -1) and
    (-1, n-1) with score 0, which win ties: the last row is scanned before
    the last column, each with its boundary entry first."""
    mode = Mode.parse(mode)
    lr = outs["last_row"][:n]
    lc = outs["last_col"][:m]
    dev = lr.device
    if mode is Mode.GLOBAL:
        return torch.stack([lc[m - 1], lc.new_full((), m - 1),
                            lc.new_full((), n - 1)])
    if mode is Mode.LOCAL:
        return outs["best"].to(torch.int32)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    row = torch.cat([zero, lr])
    ri = torch.argmax(row)            # argmax returns the first maximum
    col = torch.cat([zero, lc])
    ci = torch.argmax(col)
    with profiling.wait():      # indexing by a device scalar reads it
        take = col[ci] > row[ri]
        score = torch.where(take, col[ci], row[ri])
    ei = torch.where(take, ci - 1, m - 1).to(torch.int32)
    ej = torch.where(take, n - 1, ri - 1).to(torch.int32)
    return torch.stack([score, ei, ej])


def extract_score_from_outputs(outs, m: int, n: int, mode: Mode):
    """(score, (i, j)) as Python ints."""
    end = extract_end(outs, m, n, mode)
    with profiling.wait():
        score, i, j = end.tolist()
    return score, (i, j)
