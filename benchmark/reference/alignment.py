"""The check of constructed alignments against their sequences, in plain
torch (on the card where the run has one).

An alignment is given as the library documents it: two byte buffers of
length len(query) + len(subject), prefilled with ' ', the aligned pair of
cell (i, j) at offset i + j + 1 and '_' for a gap, and its start cell.
The check replays it: the columns, in offset order, must consume the query
from the start cell's row and the subject from its column, each column at
the offset of its cell, with the symbols of the sequences; the score that
the columns add up to, and the cell they end at, are returned for the
caller to compare with the reference's optimum and end cell. With affine
gaps each maximal run of gap columns in one string also costs the gap's
opening once: a run is counted over the live columns in offset order (the
' ' offsets between them ignored), so a query gap beside a subject gap is
two runs.
"""
from __future__ import annotations

import numpy as np
import torch

EMPTY = ord(" ")
GAP = ord("_")


def _lens(buffers, device) -> torch.Tensor:
    return torch.from_numpy(np.fromiter(map(len, buffers), np.int64,
                                        len(buffers))).to(device)


def _rows(buffers, width: int, fill: int, device) -> torch.Tensor:
    """(len(buffers), width) uint8: buffer a, then `fill`."""
    lens = _lens(buffers, device)
    flat = torch.from_numpy(np.frombuffer(
        bytearray(b"".join(buffers) + bytes(1)), np.uint8)).to(device)
    offs = torch.zeros_like(lens)
    torch.cumsum(lens[:-1], 0, out=offs[1:])
    x = torch.arange(width, device=device)
    inside = x[None, :] < lens[:, None]
    idx = torch.where(inside, offs[:, None] + x[None, :], flat.shape[0] - 1)
    return torch.where(inside, flat[idx], fill).to(torch.uint8)


def replay(queries, subjects, out_qs, out_ss, starts, match: int,
           mismatch: int, gap: int, device="cpu", gap_open: int = 0):
    """(scores, ends, valid) of A alignments, as numpy arrays: the score
    their columns add up to, the cell they end at, and whether they are
    alignments of their sequences from their start cells at all (where
    not, the score and end mean nothing). Computed on `device`. Every gap
    column costs `gap`, and every run of them `gap_open` besides (affine
    gaps: `gap` is the extension)."""
    A = len(queries)
    ms, ns = _lens(queries, device), _lens(subjects, device)
    L = int((ms + ns).max())
    valid = (_lens(out_qs, device) == ms + ns) & (
        _lens(out_ss, device) == ms + ns)
    aq = _rows(out_qs, L, EMPTY, device)
    as_ = _rows(out_ss, L, EMPTY, device)
    live = aq != EMPTY
    valid &= (live == (as_ != EMPTY)).all(1)
    takes_q, takes_s = live & (aq != GAP), live & (as_ != GAP)
    valid &= ~(live & ~takes_q & ~takes_s).any(1)
    st = torch.from_numpy(np.asarray(starts, np.int64).reshape(A, 2)).to(
        device)
    i = st[:, :1] - 1 + torch.cumsum(takes_q, 1)
    j = st[:, 1:] - 1 + torch.cumsum(takes_s, 1)
    pos = torch.arange(L, device=device)[None, :]
    valid &= ~(live & (pos != i + j + 1)).any(1)
    nq, ns_ = takes_q.sum(1), takes_s.sum(1)
    ends = torch.stack([st[:, 0] + nq - 1, st[:, 1] + ns_ - 1], 1)
    cols = nq + ns_ > 0
    valid &= ~cols | ((st >= 0).all(1) & (ends[:, 0] < ms)
                      & (ends[:, 1] < ns))
    q = _rows(queries, int(ms.max()), 0, device)
    s = _rows(subjects, int(ns.max()), 0, device)
    qi = torch.gather(q, 1, i.clamp(0, q.shape[1] - 1))
    sj = torch.gather(s, 1, j.clamp(0, s.shape[1] - 1))
    valid &= ~((takes_q & (aq != qi)) | (takes_s & (as_ != sj))).any(1)
    both = takes_q & takes_s
    scores = (torch.where(both, torch.where(aq == as_, match, mismatch),
                          0).sum(1)
              + gap * (live & ~both).sum(1))
    if gap_open:
        # the offset of each column's previous live column, -1 where none
        last = torch.cummax(torch.where(live, pos, -1), 1).values
        before = torch.nn.functional.pad(last[:, :-1], (1, 0), value=-1)
        first = before < 0
        before = before.clamp(min=0)
        runs = sum((gaps & (first | ~torch.gather(gaps, 1, before))).sum(1)
                   for gaps in (live & ~takes_q, live & ~takes_s))
        scores = scores + gap_open * runs
    return scores.cpu().numpy(), ends.cpu().numpy(), valid.cpu().numpy()


def start_allowed(mode: str, starts, ends, ms, ns) -> np.ndarray:
    """Whether alignments of `mode` may start at `starts` and end at `ends`
    ((A, 2) arrays): global spans the matrix, semiglobal starts on the
    first row or column and ends on the last, local anywhere."""
    st, en = np.asarray(starts), np.asarray(ends)
    ms, ns = np.asarray(ms), np.asarray(ns)
    if mode == "global":
        return ((st == 0).all(1) & (en[:, 0] == ms - 1)
                & (en[:, 1] == ns - 1))
    if mode == "semiglobal":
        return (((st[:, 0] == 0) | (st[:, 1] == 0))
                & ((en[:, 0] == ms - 1) | (en[:, 1] == ns - 1)))
    return np.ones(st.shape[0], bool)
