"""The plain reference: linear-gap and affine-gap (Gotoh) dynamic
programming for a batch of pairs, in plain torch, row by row.

It imports nothing of the program under test and takes only the raw
sequences. For each pair it gives the optimal score and the end cell of
the alignment, by the semantics the library documents:

- global: H[-1][-1] = 0, H[i][-1] = (i + 1) * gap, H[-1][j] = (j + 1) *
  gap (affine: go + (i + 1) * ge and go + (j + 1) * ge); the end cell is
  (m - 1, n - 1);
- semiglobal: every boundary cell is 0; the end cell is the first maximum
  of the last row with the boundary cell (m - 1, -1) before it, unless the
  last column, with (-1, n - 1) before it, holds a strictly larger value;
- local: cells are clamped at 0; the end cell is the first maximum in
  row-major order, and the score is at least 0.

A linear row is the max-plus recurrence of its cells over the row above,
then the left-gap chain as one prefix maximum: H[i][j] = max over k <= j
of (cand[k] + (j - k) * gap), which is ``cummax(cand - j * gap) + j *
gap``.

An affine row (a gap of k costs go + k * ge) takes Gotoh's three states:
F[i][j] = max(H[i-1][j] + go + ge, F[i-1][j] + ge) from the row above;
T[i][j] = max(H[i-1][j-1] + sub, F[i][j]) (and 0 in local); the left gap
E[i][j] = max over -1 <= k < j of (T[i][k] + go + (j - k) * ge), with
T[i][-1] = H[i][-1], one prefix maximum of T[k] - k * ge shifted by one
column (opening a gap after a left gap never beats extending it, since
go <= 0); H = max(T, E).

Rows run in blocks of ``BLOCK`` on static buffers; on a CUDA device every
block after the first replays one CUDA graph of the block's torch
operations (the same operations, recorded once), since a long pair takes
10^5 rows of about ten small operations each.

``dtype`` is the integer type of every score; the benchmark's own runs use
int32, and a narrower type is the control (its sums wrap).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

MODES = ("global", "semiglobal", "local")
# a row's prefix maximum runs in chunks of this many columns, then over the
# chunks' maxima: one scan of a long row is slow on the card
SCAN_CHUNK = 1024
# rows a block (and a CUDA graph)
BLOCK = 256


def _pad(seqs, width: int, lut: np.ndarray, fill: int) -> np.ndarray:
    """(len(seqs), width) int64 of each byte's code in `lut`, then `fill`."""
    out = np.full((len(seqs), width), fill, np.int64)
    for b, x in enumerate(seqs):
        out[b, :len(x)] = lut[np.frombuffer(x, np.uint8)]
    return out


def align_ends(queries, subjects, mode: str, match: int, mismatch: int,
               gap: int, device="cpu", dtype=torch.int32):
    """(scores, ends) of every pair (query b against subject b) as numpy
    int64 arrays of shape (B,) and (B, 2), with linear gaps."""
    return _align(queries, subjects, mode, match, mismatch, device, dtype,
                  functools.partial(_linear_rows, gap))


def align_ends_affine(queries, subjects, mode: str, match: int,
                      mismatch: int, gap_open: int, gap_extend: int,
                      device="cpu", dtype=torch.int32):
    """(scores, ends) as :func:`align_ends` gives them, with affine gaps:
    a gap of k symbols costs gap_open + k * gap_extend."""
    return _align(queries, subjects, mode, match, mismatch, device, dtype,
                  functools.partial(_affine_rows, gap_open, gap_extend))


class _Grid(NamedTuple):
    """What a kind of gap's rows are built for: B pairs of at most N
    columns, ``rows`` rows (a whole number of blocks), the prefix maximum
    in C chunks of W columns."""

    B: int
    N: int
    C: int
    W: int
    rows: int
    glob: bool
    local: bool
    i32: dict
    low: int


def _prefix_max(cur: torch.Tensor, g: _Grid):
    """(vals, scan): ``scan()`` writes the prefix maximum of each row of
    `cur` ((B, C * W)) into `vals` ((B, C, W)), chunk by chunk and then
    over the chunks' maxima."""
    B, C, W = g.B, g.C, g.W
    vals = torch.empty((B, C, W), **g.i32)
    idx = torch.empty(vals.shape, dtype=torch.int64, device=cur.device)
    carry = torch.empty((B, C), **g.i32)
    cidx = torch.empty(carry.shape, dtype=torch.int64, device=cur.device)

    def scan() -> None:
        torch.cummax(cur.view(B, C, W), 2, out=(vals, idx))
        if C > 1:
            torch.cummax(vals[:, :, -1], 1, out=(carry, cidx))
            torch.maximum(vals[:, 1:], carry[:, :-1, None], out=vals[:, 1:])

    return vals, scan


def _linear_rows(gap: int, g: _Grid):
    """(col0, prev, row) of linear gaps: H[i][-1] of global a row; the
    state, prev[:, 0] = H[i - 1][-1] and prev[:, j + 1] = H[i - 1][j];
    ``row(sub, col0_i)`` takes it one row on, given the row's substitution
    scores."""
    B, N, C, W, i32, device = g.B, g.N, g.C, g.W, g.i32, g.i32["device"]
    dtype = i32["dtype"]
    gt = torch.tensor(gap, **i32)
    jg = torch.arange(C * W, device=device).to(dtype) * gt
    col0 = (torch.arange(1, g.rows + 1, device=device).to(dtype) * gt)[:, None]
    # the columns past N + 1 pad the last chunk and are never read
    prev = (jg.expand(B, C * W).clone() if g.glob
            else torch.zeros((B, C * W), **i32))
    cur = torch.full_like(prev, g.low)
    cur[:, 0] = 0
    vals, scan = _prefix_max(cur, g)
    dsub, up = (torch.empty((B, N), **i32) for _ in range(2))

    def row(sub, col0_i) -> None:
        torch.add(prev[:, :N], sub, out=dsub)
        torch.add(prev[:, 1:N + 1], gt, out=up)
        torch.maximum(dsub, up, out=dsub)
        if g.local:
            dsub.clamp_(min=0)
        torch.sub(dsub, jg[1:N + 1], out=cur[:, 1:N + 1])
        if g.glob:
            cur[:, :1] = col0_i
        scan()
        torch.add(vals.view(B, C * W), jg, out=prev)

    return col0, prev, row


def _affine_rows(gap_open: int, gap_extend: int, g: _Grid):
    """(col0, prev, row) as :func:`_linear_rows` gives them, of affine
    gaps; the row also carries F, and "minus infinity" (F above the first
    row, the pad of the last chunk) is half the type's least value, which
    the penalties added to it do not wrap in int32."""
    B, N, C, W, i32, device = g.B, g.N, g.C, g.W, g.i32, g.i32["device"]
    dtype = i32["dtype"]
    neg = g.low // 2
    ge = torch.tensor(gap_extend, **i32)
    goe = torch.tensor(gap_open + gap_extend, **i32)
    # column c of t, cur and vals holds j = c - 1; column 0 the boundary
    jge = (torch.arange(C * W, device=device) - 1).to(dtype) * ge
    go_jge = jge[1:N + 1] + torch.tensor(gap_open, **i32)
    col0 = (gap_open + torch.arange(1, g.rows + 1, device=device).to(dtype)
            * ge)[:, None]
    prev = torch.zeros((B, N + 1), **i32)
    if g.glob:
        prev[:, 1:] = go_jge + ge
    f = torch.full((B, N), neg, **i32)
    # t[:, 0] = H[i][-1], t[:, j + 1] = T[i][j]
    t = torch.full((B, C * W), neg, **i32)
    t[:, 0] = 0
    cur = torch.empty_like(t)
    vals, scan = _prefix_max(cur, g)
    dsub, up, e = (torch.empty((B, N), **i32) for _ in range(3))
    tt = t[:, 1:N + 1]

    def row(sub, col0_i) -> None:
        torch.add(prev[:, :N], sub, out=dsub)
        torch.add(prev[:, 1:], goe, out=up)
        torch.add(f, ge, out=f)
        torch.maximum(up, f, out=f)
        torch.maximum(dsub, f, out=tt)
        if g.local:
            tt.clamp_(min=0)
        if g.glob:
            t[:, :1] = col0_i
            prev[:, :1] = col0_i
        torch.sub(t, jge, out=cur)
        scan()
        torch.add(vals.view(B, C * W)[:, :N], go_jge, out=e)
        torch.maximum(tt, e, out=prev[:, 1:])

    return col0, prev, row


def _align(queries, subjects, mode: str, match: int, mismatch: int,
           device, dtype, rows_of):
    """(scores, ends) of the rows that ``rows_of(grid)`` builds."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    B = len(queries)
    ms = np.fromiter(map(len, queries), np.int64, B)
    ns = np.fromiter(map(len, subjects), np.int64, B)
    if B == 0 or (ms == 0).any() or (ns == 0).any():
        raise ValueError("empty sequences are not supported")
    M, N = int(ms.max()), int(ns.max())
    local, glob = mode == "local", mode == "global"
    i32 = {"dtype": dtype, "device": device}
    low = torch.iinfo(dtype).min
    # each byte that occurs gets a code 0..K-1; the subjects' padding (K)
    # matches nothing, and neither padding is ever read into a result
    present = np.unique(np.frombuffer(b"".join([*queries, *subjects]),
                                      np.uint8))
    K = len(present)
    lut = np.zeros(256, np.int64)
    lut[present] = np.arange(K)
    s = torch.from_numpy(_pad(subjects, N, lut, K)).to(device)
    # prof[b * K + c, j]: the substitution score of query code c against
    # s[b, j]; row i of pair b reads prof[sub_rows[i, b]] (rows past M,
    # which fill the last block, read code 0 and reach no result)
    codes = torch.arange(K, device=device)
    prof = torch.where(codes[None, :, None] == s[:, None, :],
                       torch.tensor(match, **i32),
                       torch.tensor(mismatch, **i32)).reshape(B * K, N)
    R = min(BLOCK, M)
    rows = -(-M // R) * R
    q = np.zeros((rows, B), np.int64)
    q[:M] = _pad(queries, M, lut, 0).T
    sub_rows = torch.from_numpy(q + np.arange(B)[None, :] * K).to(device)
    W = min(SCAN_CHUNK, N + 1)
    C = -(-(N + 1) // W)
    col0, prev, row_step = rows_of(
        _Grid(B, N, C, W, rows, glob, local, i32, low))
    irow = torch.arange(rows, device=device)

    sub = torch.empty((B, N), **i32)
    last_row = torch.zeros((B, N), **i32)
    last_col = torch.zeros((rows, B), **i32)
    ms_dev = torch.from_numpy(ms).to(device)
    # prev's column of H[i][n - 1] (prev is offset by the boundary column)
    lastj = torch.from_numpy(ns).to(device)[:, None]
    jmask = torch.arange(N, device=device)[None, :] < lastj
    jpos = torch.arange(N, device=device)[None, :].expand(B, N)
    big = torch.iinfo(torch.int64).max
    best = torch.full((B,), low, **i32)
    bi = torch.zeros(B, dtype=torch.int64, device=device)
    bj = torch.zeros(B, dtype=torch.int64, device=device)
    # the block's inputs and outputs, at fixed addresses
    blk_sub = torch.empty((R, B), dtype=torch.int64, device=device)
    blk_col0 = torch.empty((R, 1), **i32)
    blk_i = torch.empty(R, dtype=torch.int64, device=device)
    blk_col = torch.empty((R, B), **i32)

    def step(r: int) -> None:
        torch.index_select(prof, 0, blk_sub[r], out=sub)
        row_step(sub, blk_col0[r])
        row = prev[:, 1:N + 1]
        torch.gather(prev, 1, lastj, out=blk_col[r].view(B, 1))
        ends_here = (ms_dev - 1 == blk_i[r])[:, None]
        last_row.copy_(torch.where(ends_here, row, last_row))
        if local:
            masked = torch.where(jmask, row, low)
            rmax = masked.amax(1)
            rarg = torch.where(masked == rmax[:, None], jpos, big).amin(1)
            take = (blk_i[r] < ms_dev) & (rmax > best)
            best.copy_(torch.where(take, rmax, best))
            bi.copy_(torch.where(take, blk_i[r], bi))
            bj.copy_(torch.where(take, rarg, bj))

    def block() -> None:
        for r in range(R):
            step(r)

    graph = None
    for k, i0 in enumerate(range(0, rows, R)):
        blk_sub.copy_(sub_rows[i0:i0 + R])
        blk_col0.copy_(col0[i0:i0 + R])
        blk_i.copy_(irow[i0:i0 + R])
        if k == 0 or not s.is_cuda:
            block()
        else:
            if graph is None:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    block()
            graph.replay()
        last_col[i0:i0 + R].copy_(blk_col)
    if local:
        scores = best.to(torch.int64).clamp_min(0)
        return (scores.cpu().numpy(),
                torch.stack([bi, bj], 1).cpu().numpy())
    lc = last_col.T.to(torch.int64).cpu().numpy()
    lr = last_row.to(torch.int64).cpu().numpy()
    scores = np.zeros(B, np.int64)
    ends = np.zeros((B, 2), np.int64)
    for b in range(B):
        m, n = int(ms[b]), int(ns[b])
        if glob:
            scores[b], ends[b] = lc[b, m - 1], (m - 1, n - 1)
            continue
        row = np.concatenate([[0], lr[b, :n]])
        col = np.concatenate([[0], lc[b, :m]])
        ri, ci = int(np.argmax(row)), int(np.argmax(col))
        if col[ci] > row[ri]:
            scores[b], ends[b] = col[ci], (ci - 1, n - 1)
        else:
            scores[b], ends[b] = row[ri], (m - 1, ri - 1)
    return scores, ends


def brute_force(query: bytes, subject: bytes, mode: str, match: int,
                mismatch: int, gap: int):
    """(score, (i, j)) by the full matrix in plain Python: the check of
    :func:`align_ends` at tiny sizes."""
    m, n = len(query), len(subject)
    H = [[0] * (n + 1) for _ in range(m + 1)]
    for i in range(m + 1):
        for j in range(n + 1):
            if i == 0 or j == 0:
                H[i][j] = (i + j) * gap if mode == "global" else 0
                continue
            sub = match if query[i - 1] == subject[j - 1] else mismatch
            v = max(H[i - 1][j - 1] + sub, H[i - 1][j] + gap,
                    H[i][j - 1] + gap)
            H[i][j] = max(v, 0) if mode == "local" else v
    return _brute_end(H, m, n, mode)


def brute_force_affine(query: bytes, subject: bytes, mode: str, match: int,
                       mismatch: int, gap_open: int, gap_extend: int):
    """(score, (i, j)) by Gotoh's three full matrices in plain Python (a
    gap of k costs gap_open + k * gap_extend): the check of
    :func:`align_ends_affine` at tiny sizes."""
    m, n = len(query), len(subject)
    neg = float("-inf")
    H = [[0] * (n + 1) for _ in range(m + 1)]
    E = [[neg] * (n + 1) for _ in range(m + 1)]
    F = [[neg] * (n + 1) for _ in range(m + 1)]
    opened = gap_open + gap_extend
    for i in range(m + 1):
        for j in range(n + 1):
            if i == 0 or j == 0:
                H[i][j] = (gap_open + (i + j) * gap_extend
                           if mode == "global" and i + j else 0)
                continue
            E[i][j] = max(H[i][j - 1] + opened, E[i][j - 1] + gap_extend)
            F[i][j] = max(H[i - 1][j] + opened, F[i - 1][j] + gap_extend)
            sub = match if query[i - 1] == subject[j - 1] else mismatch
            v = max(H[i - 1][j - 1] + sub, E[i][j], F[i][j])
            H[i][j] = max(v, 0) if mode == "local" else v
    return _brute_end(H, m, n, mode)


def _brute_end(H, m: int, n: int, mode: str):
    """(score, (i, j)) of the full matrix H ((m + 1) x (n + 1), the
    boundary in row and column 0) by the mode's end rule."""
    if mode == "global":
        return H[m][n], (m - 1, n - 1)
    if mode == "local":
        best, cell = 0, None
        for i in range(1, m + 1):
            for j in range(1, n + 1):
                if cell is None or H[i][j] > best:
                    best, cell = H[i][j], (i - 1, j - 1)
        return max(best, 0), cell
    row = [0] + [H[m][j] for j in range(1, n + 1)]
    col = [0] + [H[i][n] for i in range(1, m + 1)]
    ri = max(range(n + 1), key=lambda k: (row[k], -k))
    ci = max(range(m + 1), key=lambda k: (col[k], -k))
    if col[ci] > row[ri]:
        return col[ci], (ci - 1, n - 1)
    return row[ri], (m - 1, ri - 1)
