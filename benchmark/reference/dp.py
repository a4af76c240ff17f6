"""The plain reference: linear-gap dynamic programming for a batch of
pairs, in plain torch, row by row.

It imports nothing of the program under test and takes only the raw
sequences. For each pair it gives the optimal score and the end cell of
the alignment, by the semantics the library documents:

- global: H[-1][-1] = 0, H[i][-1] = (i + 1) * gap, H[-1][j] = (j + 1) *
  gap; the end cell is (m - 1, n - 1);
- semiglobal: every boundary cell is 0; the end cell is the first maximum
  of the last row with the boundary cell (m - 1, -1) before it, unless the
  last column, with (-1, n - 1) before it, holds a strictly larger value;
- local: cells are clamped at 0; the end cell is the first maximum in
  row-major order, and the score is at least 0.

A row is the max-plus recurrence of its cells over the row above, then the
left-gap chain as one prefix maximum: H[i][j] = max over k <= j of
(cand[k] + (j - k) * gap), which is ``cummax(cand - j * gap) + j * gap``.

Rows run in blocks of ``BLOCK`` on static buffers; on a CUDA device every
block after the first replays one CUDA graph of the block's torch
operations (the same operations, recorded once), since a long pair takes
10^5 rows of about ten small operations each.

``dtype`` is the integer type of every score; the benchmark's own runs use
int32, and a narrower type is the control (its sums wrap).
"""
from __future__ import annotations

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
    int64 arrays of shape (B,) and (B, 2)."""
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
    g = torch.tensor(gap, **i32)
    W = min(SCAN_CHUNK, N + 1)
    C = -(-(N + 1) // W)
    jg = torch.arange(C * W, device=device).to(dtype) * g
    # H[i][-1] of global, the row's boundary entry
    col0 = (torch.arange(1, rows + 1, device=device).to(dtype) * g)[:, None]
    irow = torch.arange(rows, device=device)

    # the state: prev[:, 0] = H[i - 1][-1], prev[:, j + 1] = H[i - 1][j];
    # the columns past N + 1 pad the last chunk and are never read
    prev = (jg.expand(B, C * W).clone() if glob
            else torch.zeros((B, C * W), **i32))
    cur = torch.full_like(prev, low)
    cur[:, 0] = 0
    vals = torch.empty((B, C, W), **i32)
    idx = torch.empty(vals.shape, dtype=torch.int64, device=device)
    carry = torch.empty((B, C), **i32)
    cidx = torch.empty(carry.shape, dtype=torch.int64, device=device)
    sub, dsub, up = (torch.empty((B, N), **i32) for _ in range(3))
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
        torch.add(prev[:, :N], sub, out=dsub)
        torch.add(prev[:, 1:N + 1], g, out=up)
        torch.maximum(dsub, up, out=dsub)
        if local:
            dsub.clamp_(min=0)
        torch.sub(dsub, jg[1:N + 1], out=cur[:, 1:N + 1])
        if glob:
            cur[:, :1] = blk_col0[r]
        torch.cummax(cur.view(B, C, W), 2, out=(vals, idx))
        if C > 1:
            torch.cummax(vals[:, :, -1], 1, out=(carry, cidx))
            torch.maximum(vals[:, 1:], carry[:, :-1, None], out=vals[:, 1:])
        torch.add(vals.view(B, C * W), jg, out=prev)
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
