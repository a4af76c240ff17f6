"""The comparison that decides ``correct``: what the timed calls returned
against the plain reference, on the same inputs.

Every number compared is a count of answers that the reference refutes,
and each has the limit 0 (the library promises the exact optimum):

- ``failed_calls``: calls of the window that raised;
- ``missing``: pairs of a checked call that got no answer;
- ``score_mismatch``: answers whose score is not the reference's optimum;
- ``end_mismatch``: constructed alignments that do not end at the
  reference's end cell (the mode's documented tie rule);
- ``invalid_alignment``: constructed alignments whose columns are not an
  alignment of the two sequences from their start cell, whose columns do
  not add up to their score, or whose start or end the mode does not
  allow.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import alignment as ref_alignment
from benchmark.reference import dp

LIMITS = {"failed_calls": 0, "missing": 0, "score_mismatch": 0,
          "end_mismatch": 0, "invalid_alignment": 0}
ALIGNMENT_CHECKS = ("end_mismatch", "invalid_alignment")


def reference_ends(item, mode: str, scoring: dict, device,
                   dtype=torch.int32):
    """(scores, ends) of the plain reference on one call's pairs, under the
    configuration's scoring: linear (``gap``) or affine (``gap_open``,
    ``gap_extend``)."""
    args = (item.queries, item.subjects, mode, scoring["match"],
            scoring["mismatch"])
    if scoring["kind"] == "linear":
        return dp.align_ends(*args, scoring["gap"], device, dtype)
    if scoring["kind"] == "affine":
        return dp.align_ends_affine(*args, scoring["gap_open"],
                                    scoring["gap_extend"], device, dtype)
    raise ValueError(f"unknown scoring kind {scoring['kind']!r}")


def compare(item, answers, ref_scores, ref_ends, mode: str, scoring: dict,
            kind: str, counts: dict, device="cpu") -> None:
    """Add one checked call's counts to `counts`. `answers` is the call's
    list of per-pair results: ints for ``kind`` "score", objects with
    ``score``, ``query_aligned``, ``subject_aligned`` and ``start`` for
    "alignment" (replayed on `device`)."""
    pairs = len(item.queries)
    got = len(answers) if answers is not None else 0
    counts["missing"] += max(0, pairs - got)
    if not got:
        return
    if kind == "score":
        scores = np.asarray(answers, np.int64)[:pairs]
        count_scores(scores, ref_scores, counts)
        return
    answers = list(answers)[:pairs]
    A = len(answers)
    qs, ss = item.queries[:A], item.subjects[:A]
    scores = np.fromiter((int(a.score) for a in answers), np.int64, A)
    starts = np.array([tuple(a.start) for a in answers], np.int64)
    count_scores(scores, ref_scores, counts)
    if scoring["kind"] == "affine":
        gap, gap_open = scoring["gap_extend"], scoring["gap_open"]
    else:
        gap, gap_open = scoring["gap"], 0
    replayed, ends, valid = ref_alignment.replay(
        qs, ss, [a.query_aligned for a in answers],
        [a.subject_aligned for a in answers], starts, scoring["match"],
        scoring["mismatch"], gap, device, gap_open)
    ms = np.fromiter(map(len, qs), np.int64, A)
    ns = np.fromiter(map(len, ss), np.int64, A)
    valid &= (replayed == scores) & ref_alignment.start_allowed(
        mode, starts, ends, ms, ns)
    counts["invalid_alignment"] += int((~valid).sum())
    count_ends(ends, valid, ref_ends, counts)


def count_scores(scores, ref_scores, counts: dict) -> None:
    """Add the answers' scores that are not the reference's optimum."""
    counts["score_mismatch"] += int(
        (scores != ref_scores[:scores.shape[0]]).sum())


def count_ends(ends, valid, ref_ends, counts: dict) -> None:
    """Add the alignments that are not valid or do not end at the
    reference's end cell."""
    counts["end_mismatch"] += int(
        (~valid | (ends != ref_ends[:ends.shape[0]]).any(1)).sum())


def lines(counts: dict) -> dict:
    """{name: {"value", "limit"}} of the numbers this cell compares."""
    return {k: {"value": int(v), "limit": LIMITS[k]} for k, v in counts.items()}


def passed(counts: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in counts.items())


def new_counts(kind: str) -> dict:
    names = ["failed_calls", "missing", "score_mismatch"]
    if kind == "alignment":
        names += ALIGNMENT_CHECKS
    return dict.fromkeys(names, 0)
