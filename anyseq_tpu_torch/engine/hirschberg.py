"""Linear-memory (Hirschberg) construction, linear gaps, one device.

The port of the JAX package's ``engine/hirschberg.py`` (``_hb_global`` and
``align_hirschberg`` without the mesh and checkpoint branches), with the
same splits and therefore the same strings:

* every divide level runs all its parts at once: a part's left half
  forward and its right half reversed give the two boundary columns, and
  ``kernels.lastcols.hb_merge`` picks the split row (hb_sum, ties to the
  smallest k). Levels of one or two parts run each half as one wide
  single-pair sweep (K1), transposed so that the half's last column is
  the sweep's last row; deeper levels run every half in one batched
  sweep (K4). Only the (P,) split rows and scores come back to the host;
* parts of width <= ``MIN_WIDTH`` (or of height <= 1) are terminal
  stripes: a batched pred sweep in torch, then the batched walk (K3),
  whose walked positions are copied into the output buffers on the
  device;
* semiglobal and local alignments first find the end cell (forward sweep)
  and the start cell (reverse sweep on the reversed end prefix), then run
  the global construction on that rectangle.

``MIN_WIDTH`` is 256 on every device: the stripe boundaries decide tie
cells in the strings, and the JAX package uses 256 off the TPU.
"""
from __future__ import annotations

import torch

from anyseq_tpu_torch.core.types import (
    EMPTY_SYM,
    GAP_SYM,
    Alignment,
    LinearScoring,
    Mode,
    as_tensor,
    require_linear,
)
from anyseq_tpu_torch.engine import batch, linmem
from anyseq_tpu_torch.kernels import lastcols, wavefront

MIN_WIDTH = 256
TERMINAL_BATCH = 512


def _bucket(x: int, mult: int = 256) -> int:
    return max(mult, (x + mult - 1) // mult * mult)


def _gather(seq, lo, length, rev, width: int):
    """(B, width) uint8: row b is seq[lo_b : lo_b + length_b], reversed
    where rev_b. Positions past length_b hold some symbol of seq; the
    sweeps never read them into a result."""
    x = torch.arange(width, device=seq.device)[None, :]
    lo, length = lo[:, None], length[:, None]
    idx = torch.where(rev[:, None], lo + length - 1 - x, lo + x)
    return seq[idx.clamp(0, seq.shape[0] - 1)]


def _level_per_half(q, s, parts, sc: LinearScoring):
    """Boundary columns of a level of few, wide parts: one K1 sweep per
    half, transposed (GLOBAL linear DP is transpose-symmetric)."""
    cols = []
    for qlo, qhi, slo, shi in parts:
        mid = (shi - slo) // 2
        for qa, sa in ((q[qlo:qhi], s[slo:slo + mid]),
                       (q[qlo:qhi].flip(0), s[slo + mid:shi].flip(0))):
            cols.append(wavefront.score(sa, qa, Mode.GLOBAL, sc)["last_row"])
    width = max(c.shape[0] for c in cols)
    cols = torch.stack([torch.nn.functional.pad(c, (0, width - c.shape[0]))
                        for c in cols])
    return cols[0::2], cols[1::2]


def _level_batched(q, s, parts, sc: LinearScoring):
    """Boundary columns of a level: every half in one K4 sweep."""
    dev = q.device
    qlo, slo, hs, ws, rev = [], [], [], [], []
    for a, b, c, d in parts:
        mid = (d - c) // 2
        qlo += [a, a]
        hs += [b - a, b - a]
        slo += [c, c + mid]
        ws += [mid, d - c - mid]
        rev += [False, True]

    def t(v, dtype=torch.int64):
        return torch.tensor(v, dtype=dtype, device=dev)

    rev_t = t(rev, torch.bool)
    q3 = _gather(q, t(qlo), t(hs), rev_t, max(hs))
    s3 = _gather(s, t(slo), t(ws), rev_t, max(ws))
    cols = lastcols.last_cols(q3, s3, t(hs, torch.int32), t(ws, torch.int32),
                              sc)
    return cols[0::2], cols[1::2]


def _write_all_gap_subject(s, base: int, out_q, out_s) -> None:
    """Subject symbols against query gaps (a part of height 0)."""
    out_q[base: base + s.shape[0]] = GAP_SYM
    out_s[base: base + s.shape[0]] = s


def _terminals(q, s, terminals, off, out_q, out_s, sc: LinearScoring):
    """Walk the terminal stripes into out_q / out_s (whose last slot takes
    the writes of unwalked positions). Returns the score of a stripe that
    is the whole problem, else None."""
    dev = q.device
    dump = out_q.shape[0] - 1
    root = (0, q.shape[0], 0, s.shape[0])
    root_score = None
    groups: dict[tuple[int, int], list] = {}
    for part in terminals:
        h, w = part[1] - part[0], part[3] - part[2]
        groups.setdefault((_bucket(h), _bucket(w, 128)), []).append(part)
    for (Hb, Wb), parts in groups.items():
        for lo in range(0, len(parts), TERMINAL_BATCH):
            chunk = parts[lo: lo + TERMINAL_BATCH]
            qlo = torch.tensor([p[0] for p in chunk], device=dev)
            slo = torch.tensor([p[2] for p in chunk], device=dev)
            hs = torch.tensor([p[1] - p[0] for p in chunk], device=dev)
            ws = torch.tensor([p[3] - p[2] for p in chunk], device=dev)
            fwd = torch.zeros(len(chunk), dtype=torch.bool, device=dev)
            q3 = _gather(q, qlo, hs, fwd, Hb)
            s3 = _gather(s, slo, ws, fwd, Wb)
            oq, os_, scores = batch.preds_walk_batch(q3, s3, hs, ws, sc)
            if root in chunk:
                root_score = int(scores[chunk.index(root)])
            # copy only the walked positions: a stripe's unwalked slots
            # belong to no one, but the buffer is shared
            pos = (off + qlo + slo)[:, None] + torch.arange(Hb + Wb,
                                                            device=dev)
            walked = (oq != EMPTY_SYM) | (os_ != EMPTY_SYM)
            pos = torch.where(walked, pos, dump).reshape(-1)
            out_q.index_put_((pos,), oq.reshape(-1))
            out_s.index_put_((pos,), os_.reshape(-1))
    return root_score


def _hb_global(q, s, off: int, out_q, out_s, sc: LinearScoring) -> int:
    """Level-synchronous global Hirschberg of q against s (both
    non-empty), whose cell (i, j) lands at position off + i + j + 1 of
    out_q / out_s. Returns the global score."""
    m, n = q.shape[0], s.shape[0]
    g = sc.gap
    root_score = None
    active: list[tuple[int, int, int, int]] = []
    terminals: list[tuple[int, int, int, int]] = []

    def classify(part):
        qlo, qhi, slo, shi = part
        h, w = qhi - qlo, shi - slo
        if h == 0:
            _write_all_gap_subject(s[slo:shi], off + qlo + slo, out_q, out_s)
        elif w <= MIN_WIDTH or w < 2 or h <= 1:
            terminals.append(part)
        else:
            active.append(part)

    classify((0, m, 0, n))
    while active:
        parts, active = active, []
        level = _level_per_half if len(parts) <= 2 else _level_batched
        L, R = level(q, s, parts, sc)
        dev = L.device
        hs = torch.tensor([p[1] - p[0] for p in parts], device=dev)
        mids = torch.tensor([(p[3] - p[2]) // 2 for p in parts], device=dev)
        rights = torch.tensor([p[3] - p[2] for p in parts], device=dev) - mids
        ks, scores = lastcols.hb_merge(L, R, hs, mids, rights, g)
        ks, scores = torch.stack([ks, scores]).tolist()
        for (qlo, qhi, slo, shi), k, score in zip(parts, ks, scores):
            if root_score is None:
                root_score = score
            mid = (shi - slo) // 2
            classify((qlo, qlo + k + 1, slo, slo + mid))
            classify((qlo + k + 1, qhi, slo + mid, shi))
    term = _terminals(q, s, terminals, off, out_q, out_s, sc)
    return root_score if root_score is not None else term


def _reverse_end(outs, mr: int, nr: int, g: int) -> torch.Tensor:
    """Start of a semiglobal alignment from the GLOBAL sweep of the
    reversed end prefix: the best cell of its last row or column, or one
    of the all-gap boundary cells (interior candidates win ties)."""
    lrow, lcol = outs["last_row"], outs["last_col"]
    rj = torch.argmax(lrow)
    score, ri = lrow[rj].to(torch.int64), rj.new_full((), mr - 1)
    ci = torch.argmax(lcol)
    take = lcol[ci] > score
    score = torch.where(take, lcol[ci].to(torch.int64), score)
    ri = torch.where(take, ci, ri)
    rj = torch.where(take, nr - 1, rj)
    for cand, i, j in ((g * mr, mr - 1, -1), (g * nr, -1, nr - 1)):
        take = cand > score
        score = torch.where(take, cand, score)
        ri = torch.where(take, i, ri)
        rj = torch.where(take, j, rj)
    return torch.stack([score, ri, rj])


def align_hirschberg(query, subject, mode, scoring=LinearScoring(),
                     device="cuda", mesh=None,
                     checkpoint_path=None) -> Alignment:
    """Linear-memory alignment construction on `device`."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-device construction is not ported yet "
            "(ROADMAP queue 1, item 12)")
    if checkpoint_path is not None:
        raise NotImplementedError(
            "checkpoint/resume is not ported yet (ROADMAP queue 1, item 9)")
    mode = Mode.parse(mode)
    sc = require_linear(scoring)
    q = as_tensor(query, device)
    s = as_tensor(subject, device)
    m, n = q.shape[0], s.shape[0]
    if m == 0 or n == 0:
        raise ValueError("empty sequences are not supported")
    # one extra slot takes the writes of unwalked stripe positions
    out_q = torch.full((m + n + 1,), EMPTY_SYM, dtype=torch.uint8,
                       device=q.device)
    out_s = out_q.clone()

    def result(score, start):
        return Alignment(score, bytes(out_q[:-1].cpu().numpy()),
                         bytes(out_s[:-1].cpu().numpy()), start)

    if mode is Mode.GLOBAL:
        return result(_hb_global(q, s, 0, out_q, out_s, sc), (0, 0))

    outs = wavefront.score(q, s, mode, sc)
    score, ei, ej = linmem.extract_end(outs, m, n, mode).tolist()
    if ei < 0 or ej < 0 or (mode is Mode.LOCAL and score <= 0):
        # empty alignment: a boundary maximum, or no positive local cell
        return result(score, (ei + 1, ej + 1))

    qr = q[: ei + 1].flip(0)
    sr = s[: ej + 1].flip(0)
    if mode is Mode.LOCAL:
        rscore, ri, rj = wavefront.score(qr, sr, mode, sc)["best"].tolist()
    else:
        # GLOBAL inits pin the reverse start to the forward end cell
        outs = wavefront.score(qr, sr, Mode.GLOBAL, sc)
        rscore, ri, rj = _reverse_end(outs, ei + 1, ej + 1, sc.gap).tolist()
    si, sj = ei - ri, ej - rj
    if si > ei or sj > ej:
        return result(score, (si, sj))
    sub_score = _hb_global(q[si: ei + 1], s[sj: ej + 1], si + sj, out_q,
                           out_s, sc)
    if not sub_score == score == rscore:
        raise RuntimeError(
            f"hirschberg endpoint reduction mismatch: fwd={score} "
            f"rev={rscore} rect={sub_score} (mode={mode}, m={m}, n={n}, "
            f"end=({ei},{ej}), start=({si},{sj}))")
    return result(score, (si, sj))
