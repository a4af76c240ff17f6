"""Batched row sweeps and the batched traceback walks, in plain torch,
and the many-pair API on top of them.

These are the plain versions of five kernels: :func:`swarm_batch` of the
batch sweep (K7, ``kernels/swarm.py``), :func:`last_cols_batch` of the
linear level sweep (K4, ``kernels/lastcols.py``),
:func:`last_cols_batch_affine` of the affine one (K5L, same module),
:func:`walk_batch_ends` of the linear traceback walk (K3,
``kernels/walk.py``) and :func:`walk_batch_affine_ends` of the 3-state
affine walk (K6, same module). :func:`preds_batch` and
:func:`preds_batch_affine`, the terminal-stripe pred sweeps of the
Hirschberg and Myers-Miller constructions, have no kernel: they are XLA
scans in the JAX package too. One pair of row generators (:func:`_rows`,
:func:`_affine_rows`) carries the recurrence for all of them.

Problems are padded into (B, M) / (B, N) uint8 arrays with per-problem
lengths ``ms`` / ``ns``. What lies past a problem's lengths is never read
into a result: rows past ``ms[b]`` keep their carry, and a column only
feeds the columns to its right.

:func:`align_scores_batch` and :func:`align_batch` score and align many
pairs: pairs are bucketed by padded shape, each bucket staged in bulk and
swept by K7 in chunks sized by memory; linear alignments are walked by K3
over K7's codes.
"""
from __future__ import annotations

import numpy as np
import torch

from anyseq_tpu_torch.core.types import (
    EMPTY_SYM,
    GAP_SYM,
    NEG,
    PRED_GAP_Q,
    PRED_GAP_S,
    PRED_NO_GAP,
    PRED_NONE,
    SCORE_MIN,
    AffineScoring,
    Alignment,
    LinearScoring,
    Mode,
    as_u8,
    check_scoring,
)
from anyseq_tpu_torch.engine.affine import (
    CODES4_PER_WORD,
    affine_row,
    pack_codes4,
    pred_codes4,
)
from anyseq_tpu_torch.engine.linmem import CODES_PER_WORD, _init, pack_codes


def _rows(q, s, ms, mode: Mode, sc: LinearScoring, emit_preds: bool):
    """Row sweep over a batch in `mode`: yields (i, row, code) per row,
    with ``row`` already held at its carry for problems shorter than i.
    GLOBAL boundaries are (k + 1) * gap, the other modes' 0; LOCAL clamps
    at 0."""
    B, N = s.shape
    dev = s.device
    g = sc.gap
    jg = torch.arange(N, dtype=torch.int32, device=dev) * g
    prev = _init(mode, sc, torch.arange(N, dtype=torch.int32, device=dev)
                 ).expand(B, N)
    q32 = q.to(torch.int32)
    s32 = s.to(torch.int32)
    ms = ms.to(device=dev, dtype=torch.int64)
    for i in range(int(ms.max())):
        active = (i < ms)[:, None]
        col_i = _init(mode, sc, i)
        diag = torch.cat([prev.new_full((B, 1), _init(mode, sc, i - 1)),
                          prev[:, :-1]], 1)
        qi = q32.gather(1, torch.clamp_max(ms - 1, i)[:, None])
        dsub = diag + torch.where(qi == s32, sc.match, sc.mismatch)
        cand = torch.maximum(dsub, prev + g)
        if mode is Mode.LOCAL:
            cand = cand.clamp_min(0)
        run = torch.clamp_min(torch.cummax(cand - jg, 1).values, col_i + g)
        row = run + jg
        code = None
        if emit_preds:
            left = torch.cat([row.new_full((B, 1), col_i), row[:, :-1]], 1)
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
    for i, row, _ in _rows(q, s, ms, Mode.GLOBAL, sc, emit_preds=False):
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
    for i, row, code in _rows(q, s, ms, Mode.GLOBAL, sc, emit_preds=True):
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


def _affine_rows(q, s, ms, mode: Mode, sc: AffineScoring, sgap,
                 emit_preds: bool):
    """Gotoh row sweep over a batch in `mode`: yields (i, H, E, code) per
    row, with H (and the F carry) held for problems shorter than i.
    GLOBAL: each problem's top row continues a paid gap run where ``sgap``
    (``affine.score_rows_affine`` start_gap). The other modes have 0
    boundaries (``sgap`` is not read) and LOCAL clamps at 0."""
    B, N = s.shape
    dev = s.device
    go, ge = sc.gap_open, sc.gap_extend
    glob = mode is Mode.GLOBAL
    jge = torch.arange(N, dtype=torch.int32, device=dev) * ge
    i32 = {"dtype": torch.int32, "device": dev}
    zero = torch.zeros((B, 1), **i32)
    if glob:
        sg = sgap.to(device=dev, dtype=torch.bool)[:, None]
        H = ((torch.arange(N, **i32) + 1) * ge).expand(B, N) + torch.where(
            sg, torch.zeros(1, **i32), go)
    else:
        H = torch.zeros((B, N), **i32)
    F = torch.full((B, N), NEG, **i32)
    q32 = q.to(torch.int32)
    s32 = s.to(torch.int32)
    ms = ms.to(device=dev, dtype=torch.int64)
    neg = torch.full((1,), NEG, **i32)
    for i in range(int(ms.max())):
        active = (i < ms)[:, None]
        col_i = col_im1 = zero
        if glob:
            col_i = torch.where(sg, neg, go + (i + 1) * ge)
            col_im1 = torch.where(sg, neg, 0 if i == 0 else go + i * ge)
        diag = torch.cat([col_im1, H[:, :-1]], 1)
        qi = q32.gather(1, torch.clamp_max(ms - 1, i)[:, None])
        sub = torch.where(qi == s32, sc.match, sc.mismatch)
        Hn, E, Fn, dsub = affine_row(H, F, sub, diag, col_i, jge,
                                     mode is Mode.LOCAL, sc)
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
    for i, H, E, _ in _affine_rows(q, s, ms, Mode.GLOBAL, sc, sgap,
                                    False):
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
    for i, H, E, code in _affine_rows(q, s, ms, Mode.GLOBAL, sc, sgap,
                                       True):
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


def swarm_batch(q, s, ms, ns, mode: Mode, sc, sgaps=None,
                need_pos: bool = True, emit_preds: bool = False):
    """The batch sweep of K7 (``kernels/swarm.py``): B independent
    problems in `mode`, linear or affine.

    q: (B, M) uint8, s: (B, N) uint8, ms/ns: (B,) lengths >= 1; sgaps:
    (B,) start-gap flags of affine GLOBAL problems (all False when None).
    Returns the per-problem contract of the JAX package's
    ``swarm.score_pairs_swarm``, int32 on the inputs' device:

      last_rows (B, N)  H[m-1][0..n)
      last_cols (B, M)  H[0..m)[n-1]
      best      (B, 3)  GLOBAL (H[m-1][n-1], m-1, n-1); SEMIGLOBAL (max of
                        the last column, 0, 0); LOCAL (score, i, j) of the
                        first maximum in row-major order, (score, 0, 0)
                        without ``need_pos``
      preds     with ``emit_preds``: (B, M, ceil(N/16)) 2-bit codes of
                        ``linmem.pack_codes`` (linear), (B, M, ceil(N/8))
                        4-bit codes of ``affine.pack_codes4`` (affine)

    Every entry past a problem's lengths is 0."""
    mode = Mode.parse(mode)
    affine = isinstance(sc, AffineScoring)
    B, M = q.shape
    N = s.shape[1]
    dev = s.device
    i32 = {"dtype": torch.int32, "device": dev}
    ms = ms.to(device=dev, dtype=torch.int64)
    ns = ns.to(device=dev, dtype=torch.int64)
    jmask = torch.arange(N, device=dev)[None, :] < ns[:, None]
    imask = torch.arange(M, device=dev)[None, :] < ms[:, None]
    lastj = (ns - 1)[:, None]
    last_cols = torch.zeros((B, M), **i32)
    per_word, pack = ((CODES4_PER_WORD, pack_codes4) if affine
                      else (CODES_PER_WORD, pack_codes))
    preds = (torch.zeros((B, M, -(-N // per_word)), **i32)
             if emit_preds else None)
    vmax = torch.full((B,), SCORE_MIN, **i32)
    vi = torch.zeros(B, dtype=torch.int64, device=dev)
    vj = torch.zeros(B, dtype=torch.int64, device=dev)
    if affine:
        if sgaps is None:
            sgaps = torch.zeros(B, dtype=torch.bool, device=dev)
        rows = ((i, H, code) for i, H, _, code in
                _affine_rows(q, s, ms, mode, sc, sgaps, emit_preds))
    else:
        rows = _rows(q, s, ms, mode, sc, emit_preds)
    for i, row, code in rows:
        last_cols[:, i] = row.gather(1, lastj)[:, 0]
        if emit_preds:
            live = jmask & (i < ms)[:, None]
            preds[:, i] = pack(torch.where(live, code, PRED_NONE))
        if mode is Mode.LOCAL:
            masked = torch.where(jmask, row, SCORE_MIN)
            rarg = torch.argmax(masked, 1)        # first maximum of the row
            rmax = masked.gather(1, rarg[:, None])[:, 0]
            take = (i < ms) & (rmax > vmax)
            vmax = torch.where(take, rmax, vmax)
            vi = torch.where(take, i, vi)
            vj = torch.where(take, rarg, vj)
    last_cols = torch.where(imask, last_cols, 0)
    zeros = torch.zeros_like(ms)
    if mode is Mode.GLOBAL:
        best = [last_cols.gather(1, (ms - 1)[:, None])[:, 0], ms - 1, ns - 1]
    elif mode is Mode.SEMIGLOBAL:
        best = [torch.where(imask, last_cols, SCORE_MIN).max(1).values,
                zeros, zeros]
    elif need_pos:
        best = [vmax.clamp_min(0), vi, vj]
    else:
        best = [vmax.clamp_min(0), zeros, zeros]
    outs = {"last_rows": torch.where(jmask, row, 0),
            "last_cols": last_cols,
            "best": torch.stack([b.to(torch.int32) for b in best], 1)}
    if emit_preds:
        outs["preds"] = preds
    return outs


def extract_batch(res, ms, ns, mode: Mode):
    """(B,) int32 scores and (B, 2) int32 end cells from the outputs of
    :func:`swarm_batch` (the port of the JAX package's
    ``swarm.extract_batch``: the candidates of
    ``linmem.extract_end``, in the same order and with the same ties).
    SEMIGLOBAL: the last row, with the j = -1 boundary first, then the
    last column, with the i = -1 boundary first; a boundary wins ties, so
    ``ej = -1`` where the row's maximum is <= 0."""
    mode = Mode.parse(mode)
    lr, lc = res["last_rows"], res["last_cols"]
    dev = lr.device
    ms = ms.to(device=dev, dtype=torch.int64)
    ns = ns.to(device=dev, dtype=torch.int64)
    if mode is Mode.GLOBAL:
        score = lc.gather(1, (ms - 1)[:, None])[:, 0]
        return score, torch.stack([ms - 1, ns - 1], 1).to(torch.int32)
    if mode is Mode.LOCAL:
        return res["best"][:, 0], res["best"][:, 1:3]

    def first_max(x, lengths):
        x = torch.where(torch.arange(x.shape[1], device=dev)[None, :]
                        < lengths[:, None], x, SCORE_MIN)
        arg = torch.argmax(x, 1)
        return x.gather(1, arg[:, None])[:, 0], arg

    rmax, rarg = first_max(lr, ns)
    cmax, carg = first_max(lc, ms)
    score = rmax.clamp_min(0)
    ei = ms - 1
    ej = torch.where(rmax <= 0, -1, rarg)
    take = cmax.clamp_min(0) > score
    score = torch.where(take, cmax, score)
    ei = torch.where(take, carg, ei)
    ej = torch.where(take, ns - 1, ej)
    return score, torch.stack([ei, ej], 1).to(torch.int32)


# Problems of one K7 launch at most: score-only, and with codes (as the
# JAX package's swarm route chunks them); fewer where a chunk's device
# memory would pass CHUNK_BYTES.
SCORE_CHUNK = 8192
ALIGN_CHUNK = 4096
CHUNK_BYTES = 1 << 30


def _bucket(lens: np.ndarray, mult: int = 256) -> np.ndarray:
    return np.maximum(mult, -(-lens // mult) * mult)


def _flat(seqs):
    """All sequences of one side joined into one uint8 array (with a
    bucket's width of zeros after the last), their offsets and lengths."""
    raw = [x if isinstance(x, bytes) else as_u8(x).tobytes() for x in seqs]
    lens = np.fromiter(map(len, raw), np.int64, len(raw))
    if (lens == 0).any():
        raise ValueError("empty sequences are not supported")
    offs = np.zeros(len(raw), np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    tail = bytes(int(_bucket(lens.max())))
    return np.frombuffer(b"".join(raw) + tail, np.uint8), offs, lens


def _stage(flat, idx, width: int) -> np.ndarray:
    """(len(idx), width) uint8: row r holds sequence idx[r], then whatever
    bytes follow it in the joined array (real symbols: the sweeps and
    walks never read past a problem's lengths into a result)."""
    data, offs, _ = flat
    return np.lib.stride_tricks.sliding_window_view(data, width)[offs[idx]]


def _chunks(queries, subjects, cap: int, code_bits: int,
            affine: bool = False):
    """Bucket the pairs by padded shape and stage each chunk in bulk.
    Yields (idx, q, s, ms, ns) per chunk: the pairs' input positions and
    host arrays (q (B, M) / s (B, N) uint8, ms / ns (B,) int32), at most
    `cap` problems and about CHUNK_BYTES of device memory a chunk (K7's,
    for `affine` scoring, with codes of `code_bits` bits a cell)."""
    from anyseq_tpu_torch.kernels import swarm

    if len(queries) != len(subjects):
        raise ValueError("queries and subjects must have equal length")
    if not len(queries):
        return
    fq, fs = _flat(queries), _flat(subjects)
    Ms, Ns = _bucket(fq[2]), _bucket(fs[2])
    keys, first, inverse = np.unique(Ms << 32 | Ns, return_index=True,
                                     return_inverse=True)
    order = np.argsort(inverse, kind="stable")
    groups = np.split(order, np.cumsum(np.bincount(inverse))[:-1])
    for g in np.argsort(first):            # buckets in order of appearance
        M, N = int(keys[g] >> 32), int(keys[g] & 0xFFFFFFFF)
        # the sequences, last row and last column, K7's boundary columns
        # and the codes
        per_problem = ((M + N) * 5
                       + swarm.boundary_bytes(M, N, affine, code_bits > 0)
                       + M * N * code_bits // 8)
        step = max(1, min(cap, CHUNK_BYTES // per_problem))
        for lo in range(0, len(groups[g]), step):
            idx = groups[g][lo: lo + step]
            yield (idx, _stage(fq, idx, M), _stage(fs, idx, N),
                   fq[2][idx].astype(np.int32), fs[2][idx].astype(np.int32))


def _to(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def align_scores_batch(queries, subjects, mode="global",
                       scoring=LinearScoring(), batch_size: int = 512,
                       device="cuda") -> np.ndarray:
    """Score many pairs (record i of `queries` against record i of
    `subjects`; str, bytes or uint8 arrays). Returns an np.int64 array of
    scores in input order.

    Pairs are bucketed by padded shape; each chunk of a bucket is one K7
    sweep on `device` (a CPU device runs its plain version), score-only.
    ``batch_size`` is accepted for the JAX package's signature: the chunk
    size is set by device memory."""
    from anyseq_tpu_torch.kernels import swarm

    del batch_size
    mode = Mode.parse(mode)
    sc = check_scoring(scoring)
    out = np.zeros(len(queries), dtype=np.int64)
    for idx, *arrays in _chunks(queries, subjects, SCORE_CHUNK, 0,
                                isinstance(sc, AffineScoring)):
        q, s, ms, ns = _to(device, *arrays)
        # the lengths on the host: K7's strip list is built there
        res = swarm.score_pairs_swarm(q, s, *arrays[2:], mode, sc,
                                      need_pos=False)
        out[idx] = extract_batch(res, ms, ns, mode)[0].cpu().numpy()
    return out


def align_batch(queries, subjects, mode="global", scoring=LinearScoring(),
                batch_size: int = 256, mesh=None,
                device="cuda") -> list[Alignment]:
    """Construct alignments for many pairs; a list of Alignment in input
    order.

    Linear gaps: per chunk of a bucket, K7 sweeps with 2-bit codes, the
    score and end cell are extracted on the device, and K3 walks every
    problem from its end cell (GLOBAL (m-1, n-1); LOCAL the best cell,
    no walk where the score is <= 0; SEMIGLOBAL the extracted end); the
    chunk's scores, cells and strings come back in one copy. Affine gaps
    go pair by pair through ``api.align``, as in the JAX package. With a
    ``mesh`` (``dist.mesh.Mesh``), linear pairs are split over its devices
    in order (``dist.batch.align_batch_sharded``) and affine pairs run on
    its first device of this process (on each process of a mesh over
    several); `device` is not read.
    ``batch_size`` is accepted for the JAX package's signature: the chunk
    size is set by device memory."""
    from anyseq_tpu_torch.engine import api
    from anyseq_tpu_torch.kernels import swarm, walk

    del batch_size
    mode = Mode.parse(mode)
    sc = check_scoring(scoring)
    if mesh is not None:
        from anyseq_tpu_torch.dist import batch as dist_batch
        from anyseq_tpu_torch.dist.mesh import check_mesh

        check_mesh(mesh)
        if not isinstance(sc, AffineScoring):
            return dist_batch.align_batch_sharded(queries, subjects, mode,
                                                  sc, mesh)
        device = mesh.home
    if isinstance(sc, AffineScoring):
        if len(queries) != len(subjects):
            raise ValueError("queries and subjects must have equal length")
        return [api.align(a, b, mode, sc, device=device)
                for a, b in zip(queries, subjects)]
    out: list = [None] * len(queries)
    for idx, *arrays in _chunks(queries, subjects, ALIGN_CHUNK, 2):
        q, s, ms, ns = _to(device, *arrays)
        res = swarm.score_pairs_swarm(q, s, *arrays[2:], mode, sc,
                                      emit_preds=True)
        score, end = extract_batch(res, ms, ns, mode)
        end = end.contiguous()
        walked = (score > 0)[:, None] | (mode is not Mode.LOCAL)
        # LOCAL with a best <= 0: no walk, the empty alignment with start
        # = end + 1, as the single-pair path gives
        oq, os_, starts = walk.walk(res["preds"], q, s,
                                    torch.where(walked, end, -1), mode)
        starts = torch.where(walked, starts, end + 1)
        ints = torch.cat([score[:, None], starts], 1).to(torch.int32)
        host = torch.cat([ints.contiguous().view(torch.uint8), oq, os_],
                         1).cpu().numpy()
        L = oq.shape[1]
        ints = np.ascontiguousarray(host[:, :12]).view(np.int32).tolist()
        lens = (arrays[2] + arrays[3]).tolist()
        for r, (i, (sc_r, si, sj), n) in enumerate(zip(idx.tolist(), ints,
                                                       lens)):
            out[i] = Alignment(sc_r, host[r, 12: 12 + n].tobytes(),
                               host[r, 12 + L: 12 + L + n].tobytes(),
                               (si, sj))
    return out
