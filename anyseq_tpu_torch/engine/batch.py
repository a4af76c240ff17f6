"""Batched row sweeps and the batched traceback walks, in plain torch.

These are the plain versions of four kernels: :func:`last_cols_batch` of
the linear level sweep (K4, ``kernels/lastcols.py``),
:func:`last_cols_batch_affine` of the affine one (K5L, same module),
:func:`walk_batch_ends` of the linear traceback walk (K3,
``kernels/walk.py``) and :func:`walk_batch_affine_ends` of the 3-state
affine walk (K6, same module). :func:`preds_batch` and
:func:`preds_batch_affine`, the terminal-stripe pred sweeps of the
Hirschberg and Myers-Miller constructions, have no kernel: they are XLA
scans in the JAX package too.

Problems are padded into (B, M) / (B, N) uint8 arrays with per-problem
lengths ``ms`` / ``ns``. What lies past a problem's lengths is never read
into a result: rows past ``ms[b]`` keep their carry, and a column only
feeds the columns to its right.
"""
from __future__ import annotations

import torch

from anyseq_tpu_torch.core.types import (
    EMPTY_SYM,
    GAP_SYM,
    NEG,
    PRED_GAP_Q,
    PRED_GAP_S,
    PRED_NO_GAP,
    PRED_NONE,
    AffineScoring,
    LinearScoring,
    Mode,
)
from anyseq_tpu_torch.engine.affine import (
    CODES4_PER_WORD,
    affine_row,
    pack_codes4,
    pred_codes4,
)
from anyseq_tpu_torch.engine.linmem import CODES_PER_WORD, pack_codes


def _global_rows(q, s, ms, sc: LinearScoring, emit_preds: bool):
    """GLOBAL row sweep over a batch: yields (i, row, code) per row, with
    ``row`` already held at its carry for problems shorter than i."""
    B, N = s.shape
    dev = s.device
    g = sc.gap
    jg = torch.arange(N, dtype=torch.int32, device=dev) * g
    prev = ((torch.arange(N, dtype=torch.int32, device=dev) + 1) * g
            ).expand(B, N)
    q32 = q.to(torch.int32)
    s32 = s.to(torch.int32)
    ms = ms.to(device=dev, dtype=torch.int64)
    for i in range(int(ms.max())):
        active = (i < ms)[:, None]
        diag = torch.cat([prev.new_full((B, 1), i * g), prev[:, :-1]], 1)
        qi = q32.gather(1, torch.clamp_max(ms - 1, i)[:, None])
        dsub = diag + torch.where(qi == s32, sc.match, sc.mismatch)
        cand = torch.maximum(dsub, prev + g)
        run = torch.clamp_min(torch.cummax(cand - jg, 1).values, (i + 2) * g)
        row = run + jg
        code = None
        if emit_preds:
            left = torch.cat([row.new_full((B, 1), (i + 1) * g),
                              row[:, :-1]], 1)
            code = torch.where(
                row == dsub, PRED_NO_GAP,
                torch.where(row == left + g, PRED_GAP_Q,
                            torch.where(row == prev + g, PRED_GAP_S,
                                        PRED_NONE)))
        row = torch.where(active, row, prev)
        yield i, row, code
        prev = row


def last_cols_batch(q, s, ms, ns, sc: LinearScoring):
    """Global-DP boundary columns for a batch of pairs, in one sweep.

    q: (B, M) uint8, s: (B, N) uint8, ms/ns: (B,) lengths >= 1.
    Returns (M, B) int32: entry [i, b] = H_b[i][ns_b - 1] (a stale value
    for i >= ms_b)."""
    B, M = q.shape
    lastj = (ns.to(device=s.device, dtype=torch.int64) - 1)[:, None]
    cols = torch.zeros((M, B), dtype=torch.int32, device=s.device)
    for i, row, _ in _global_rows(q, s, ms, sc, emit_preds=False):
        cols[i] = row.gather(1, lastj)[:, 0]
    return cols


def preds_batch(q, s, ms, ns, sc: LinearScoring):
    """Global-DP predecessor codes for a batch of pairs, one sweep.

    Returns ((B, M, ceil(N/16)) int32 packed codes in the layout of
    ``linmem.pack_codes``, (M, B) int32 last columns). Priority is
    diag > gap_q > gap_s."""
    B, M = q.shape
    N = s.shape[1]
    lastj = (ns.to(device=s.device, dtype=torch.int64) - 1)[:, None]
    words = torch.zeros((B, M, -(-N // CODES_PER_WORD)), dtype=torch.int32,
                        device=s.device)
    cols = torch.zeros((M, B), dtype=torch.int32, device=s.device)
    for i, row, code in _global_rows(q, s, ms, sc, emit_preds=True):
        words[:, i] = pack_codes(code)
        cols[i] = row.gather(1, lastj)[:, 0]
    return words, cols


def walk_batch_ends(words, q, s, ends, mode: Mode):
    """Batched traceback walk from per-problem END cells over packed codes.

    words: (B, M, NW) int32 packed codes; q: (B, M) uint8; s: (B, N)
    uint8; ends: (B, 2) end cells, (-1, -1) for a dead walk. Returns
    (out_q, out_s, starts): (B, M+N) uint8 buffers prefilled with
    EMPTY_SYM, the walked pair of cell (i, j) at position i + j + 1 with
    '_' for gaps, and the (B, 2) int32 start cells. Halo cells: GLOBAL
    gives PRED_GAP_Q for i < 0, PRED_GAP_S for j < 0 and PRED_NONE for
    both; the other modes give PRED_NONE."""
    mode = Mode.parse(mode)
    B, M, NW = words.shape
    L = M + s.shape[1]
    dev = words.device
    flat = words.reshape(B, M * NW)
    i = ends[:, 0].to(device=dev, dtype=torch.int64)
    j = ends[:, 1].to(device=dev, dtype=torch.int64)
    oq = torch.full((B, L + 1), EMPTY_SYM, dtype=torch.uint8, device=dev)
    os_ = torch.full((B, L + 1), EMPTY_SYM, dtype=torch.uint8, device=dev)
    rows = torch.arange(B, device=dev)
    for step in range(L):
        ic = i.clamp_min(0)
        jc = j.clamp_min(0)
        word = flat.gather(1, (ic * NW + jc // CODES_PER_WORD)[:, None])[:, 0]
        code = ((word.to(torch.int64) & 0xFFFFFFFF)
                >> (2 * (jc % CODES_PER_WORD))) & 3
        halo = (i < 0) | (j < 0)
        if mode is Mode.GLOBAL:
            bdy = torch.where((i < 0) & (j < 0), PRED_NONE,
                              torch.where(i < 0, PRED_GAP_Q, PRED_GAP_S))
            code = torch.where(halo, bdy, code)
        else:
            code = torch.where(halo, PRED_NONE, code)
        live = code != PRED_NONE
        # a dead walk stays dead: stop once every walk is
        if step % 64 == 63 and not bool(live.any()):
            break
        tq = live & ((code == PRED_NO_GAP) | (code == PRED_GAP_S))
        ts = live & ((code == PRED_NO_GAP) | (code == PRED_GAP_Q))
        pos = torch.where(live, i + j + 1, L)
        oq[rows, pos] = torch.where(tq, q.gather(1, ic[:, None])[:, 0],
                                    GAP_SYM).to(torch.uint8)
        os_[rows, pos] = torch.where(ts, s.gather(1, jc[:, None])[:, 0],
                                     GAP_SYM).to(torch.uint8)
        i = i - tq.to(torch.int64)
        j = j - ts.to(torch.int64)
    starts = torch.stack([i + 1, j + 1], 1).to(torch.int32)
    return oq[:, :L], os_[:, :L], starts


def walk_batch(words, q, s, ms, ns):
    """GLOBAL walks from each problem's last cell (ms-1, ns-1), through
    the walk kernel's wrapper. Returns (out_q, out_s) as
    :func:`walk_batch_ends`."""
    from anyseq_tpu_torch.kernels import walk

    ends = torch.stack([ms, ns], 1).to(device=words.device,
                                       dtype=torch.int32) - 1
    oq, os_, _ = walk.walk(words, q, s, ends, Mode.GLOBAL)
    return oq, os_


def preds_walk_batch(q, s, ms, ns, sc: LinearScoring):
    """Terminal stripes: the pred sweep, then the walk. Returns
    (out_q, out_s, scores) with scores[b] = H_b[ms_b - 1][ns_b - 1]."""
    words, cols = preds_batch(q, s, ms, ns, sc)
    oq, os_ = walk_batch(words, q, s, ms, ns)
    b = torch.arange(q.shape[0], device=cols.device)
    scores = cols[ms.to(device=cols.device, dtype=torch.int64) - 1, b]
    return oq, os_, scores


def _global_affine_rows(q, s, ms, sc: AffineScoring, sgap, emit_preds: bool):
    """GLOBAL Gotoh row sweep over a batch, each problem's top row
    continuing a paid gap run where ``sgap`` (``affine.score_rows_affine``
    start_gap): yields (i, H, E, code) per row, with H (and the F carry)
    held for problems shorter than i."""
    B, N = s.shape
    dev = s.device
    go, ge = sc.gap_open, sc.gap_extend
    jge = torch.arange(N, dtype=torch.int32, device=dev) * ge
    sg = sgap.to(device=dev, dtype=torch.bool)[:, None]
    i32 = {"dtype": torch.int32, "device": dev}
    H = ((torch.arange(N, **i32) + 1) * ge).expand(B, N) + torch.where(
        sg, torch.zeros(1, **i32), go)
    F = torch.full((B, N), NEG, **i32)
    q32 = q.to(torch.int32)
    s32 = s.to(torch.int32)
    ms = ms.to(device=dev, dtype=torch.int64)
    neg = torch.full((1,), NEG, **i32)
    for i in range(int(ms.max())):
        active = (i < ms)[:, None]
        col_i = torch.where(sg, neg, go + (i + 1) * ge)
        col_im1 = torch.where(sg, neg, 0 if i == 0 else go + i * ge)
        diag = torch.cat([col_im1, H[:, :-1]], 1)
        qi = q32.gather(1, torch.clamp_max(ms - 1, i)[:, None])
        sub = torch.where(qi == s32, sc.match, sc.mismatch)
        Hn, E, Fn, dsub = affine_row(H, F, sub, diag, col_i, jge, False, sc)
        code = None
        if emit_preds:
            h_left = torch.cat([col_i, Hn[:, :-1]], 1)
            code = pred_codes4(Hn, E, Fn, dsub, H, h_left, sc)
        H = torch.where(active, Hn, H)
        F = torch.where(active, Fn, F)
        yield i, H, E, code


def last_cols_batch_affine(q, s, ms, ns, sc: AffineScoring, sgap):
    """GLOBAL affine boundary columns for a batch of pairs, in one sweep.

    q: (B, M) uint8, s: (B, N) uint8, ms/ns: (B,) lengths >= 1, sgap: (B,)
    bool start-gap flags. Returns ((M, B) H columns, (M, B) E columns):
    entry [i, b] = H_b[i][ns_b - 1] / E_b[i][ns_b - 1] (stale for i >=
    ms_b)."""
    B, M = q.shape
    lastj = (ns.to(device=s.device, dtype=torch.int64) - 1)[:, None]
    cols = torch.zeros((M, B), dtype=torch.int32, device=s.device)
    cols_e = torch.full((M, B), NEG, dtype=torch.int32, device=s.device)
    for i, H, E, _ in _global_affine_rows(q, s, ms, sc, sgap, False):
        cols[i] = H.gather(1, lastj)[:, 0]
        cols_e[i] = E.gather(1, lastj)[:, 0]
    return cols, cols_e


def preds_batch_affine(q, s, ms, ns, sc: AffineScoring, sgap):
    """GLOBAL affine predecessor codes for a batch (the terminal stripes of
    the Myers-Miller construction), one sweep. Returns ((B, M, ceil(N/8))
    int32 words in the layout of ``affine.pack_codes4``, (M, B) H columns,
    (M, B) E columns)."""
    B, M = q.shape
    N = s.shape[1]
    lastj = (ns.to(device=s.device, dtype=torch.int64) - 1)[:, None]
    words = torch.zeros((B, M, -(-N // CODES4_PER_WORD)), dtype=torch.int32,
                        device=s.device)
    cols = torch.zeros((M, B), dtype=torch.int32, device=s.device)
    cols_e = torch.full((M, B), NEG, dtype=torch.int32, device=s.device)
    for i, H, E, code in _global_affine_rows(q, s, ms, sc, sgap, True):
        words[:, i] = pack_codes4(code)
        cols[i] = H.gather(1, lastj)[:, 0]
        cols_e[i] = E.gather(1, lastj)[:, 0]
    return words, cols, cols_e


def walk_batch_affine_ends(words, q, s, ends, mode: Mode, sgap, egap):
    """Batched 3-state affine traceback walk from per-problem END cells
    over 4-bit codes (the port of the JAX package's ``walk_batch_affine``
    with explicit ends and halo).

    words: (B, M, NW) int32 codes of ``affine.pack_codes4``; q: (B, M)
    uint8; s: (B, N) uint8; ends: (B, 2), (-1, -1) for a dead walk; sgap /
    egap: (B,) bool. A walk starts in state E where egap, else in H. In H
    the cell's PH picks the step (an E or F step runs at the same cell);
    an E / F step keeps its state while PE / PF says the run extends.
    Halo cells: GLOBAL gives PH = GAP_Q, PE = (sgap or j >= 1), PF = 0 for
    i < 0, PH = GAP_S, PE = 0, PF = (i >= 1) for j < 0, and stops where
    both are negative; the other modes stop at any halo cell. Returns
    (out_q, out_s, starts) as :func:`walk_batch_ends`."""
    mode = Mode.parse(mode)
    B, M, NW = words.shape
    L = M + s.shape[1]
    dev = words.device
    flat = words.reshape(B, M * NW)
    i = ends[:, 0].to(device=dev, dtype=torch.int64)
    j = ends[:, 1].to(device=dev, dtype=torch.int64)
    sg = sgap.to(device=dev, dtype=torch.bool)
    state = torch.where(egap.to(device=dev, dtype=torch.bool), PRED_GAP_Q,
                        PRED_NONE)   # PRED_NONE stands for state H
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    oq = torch.full((B, L + 1), EMPTY_SYM, dtype=torch.uint8, device=dev)
    os_ = torch.full((B, L + 1), EMPTY_SYM, dtype=torch.uint8, device=dev)
    rows = torch.arange(B, device=dev)
    for step in range(L):
        ic = i.clamp_min(0)
        jc = j.clamp_min(0)
        word = flat.gather(1, (ic * NW + jc // CODES4_PER_WORD)[:, None])[:, 0]
        c = ((word.to(torch.int64) & 0xFFFFFFFF)
             >> (4 * (jc % CODES4_PER_WORD))) & 15
        ph, pe, pf = c & 3, (c >> 2) & 1, c >> 3
        ineg, jneg = i < 0, j < 0
        if mode is Mode.GLOBAL:
            ph = torch.where(ineg, PRED_GAP_Q, torch.where(jneg, PRED_GAP_S,
                                                           ph))
            pe = torch.where(ineg, (sg | (j >= 1)).to(pe.dtype),
                             torch.where(jneg, 0, pe))
            pf = torch.where(jneg, (i >= 1).to(pf.dtype),
                             torch.where(ineg, 0, pf))
            dead = dead | (ineg & jneg)
        else:
            dead = dead | ineg | jneg
        eff = torch.where(state == PRED_NONE, ph, state)
        dead = dead | (eff == PRED_NONE)
        # a dead walk stays dead: stop once every walk is
        if step % 64 == 63 and bool(dead.all()):
            break
        live = ~dead
        tq = live & ((eff == PRED_NO_GAP) | (eff == PRED_GAP_S))
        ts = live & ((eff == PRED_NO_GAP) | (eff == PRED_GAP_Q))
        pos = torch.where(live, i + j + 1, L)
        oq[rows, pos] = torch.where(tq, q.gather(1, ic[:, None])[:, 0],
                                    GAP_SYM).to(torch.uint8)
        os_[rows, pos] = torch.where(ts, s.gather(1, jc[:, None])[:, 0],
                                     GAP_SYM).to(torch.uint8)
        nstate = torch.where((eff == PRED_GAP_Q) & (pe != 0), PRED_GAP_Q,
                             torch.where((eff == PRED_GAP_S) & (pf != 0),
                                         PRED_GAP_S, PRED_NONE))
        state = torch.where(live, nstate, state)
        i = i - tq.to(torch.int64)
        j = j - ts.to(torch.int64)
    starts = torch.stack([i + 1, j + 1], 1).to(torch.int32)
    return oq[:, :L], os_[:, :L], starts


def preds_walk_batch_affine(q, s, ms, ns, sc: AffineScoring, sgap, egap):
    """Affine terminal stripes: the pred sweep, then the walk (K6's
    wrapper) from each problem's last cell, in state E where egap.
    Returns (out_q, out_s, scores) with scores[b] the stripe's score, read
    from the E column where egap, else from H."""
    from anyseq_tpu_torch.kernels import walk

    words, cols, cols_e = preds_batch_affine(q, s, ms, ns, sc, sgap)
    ends = torch.stack([ms, ns], 1).to(device=words.device,
                                       dtype=torch.int32) - 1
    oq, os_, _ = walk.walk_affine(words, q, s, ends, Mode.GLOBAL, sgap, egap)
    b = torch.arange(q.shape[0], device=cols.device)
    last = ms.to(device=cols.device, dtype=torch.int64) - 1
    eg = egap.to(device=cols.device, dtype=torch.bool)
    scores = torch.where(eg, cols_e[last, b], cols[last, b])
    return oq, os_, scores
