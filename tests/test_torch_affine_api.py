"""The port's public API with affine (Gotoh) gaps on the CPU (every
kernel's plain version) against the JAX package on XLA:CPU: scores, end
and start cells, and the aligned byte strings must be equal, for the
score, the full traceback and the Myers-Miller construction."""
import dataclasses

import numpy as np
import pytest

import anyseq_tpu
import anyseq_tpu_torch as pt
from anyseq_tpu.engine.hirschberg import align_hirschberg
from anyseq_tpu_torch.engine import hirschberg

from conftest import mutate, random_dna

MODES = ["global", "semiglobal", "local"]
JSC = anyseq_tpu.AffineScoring(2, -1, -3, -1)
SC = pt.AffineScoring(2, -1, -3, -1)


def _pair(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "related":
        q = random_dna(rng, 500)
        return q, mutate(rng, q, 0.15, 0.08)
    if kind == "unrelated":
        return random_dna(rng, 400), random_dna(rng, 520)
    if kind == "skewed":
        q = random_dna(rng, 120)
        return q, random_dna(rng, 300) + mutate(rng, q) + random_dna(rng, 400)
    if kind == "gappy":
        q = random_dna(rng, 500)
        return q, q[:150] + q[330:]
    raise ValueError(kind)


def _astuple(aln):
    return dataclasses.astuple(aln)


def rescore_affine(aln, sc) -> int:
    """The score of an alignment's strings; each maximal run of gaps in
    one sequence pays gap_open once (a gap in the other sequence right
    after it starts a new run)."""
    total, run = 0, None
    for cq, cs in zip(*aln.compact()):
        side = "q" if cq == "_" else "s" if cs == "_" else None
        if side is None:
            total += sc.match if cq == cs else sc.mismatch
        else:
            total += sc.gap_extend + (0 if side == run else sc.gap_open)
        run = side
    return total


@pytest.mark.parametrize("kind", ["related", "unrelated", "skewed", "gappy"])
@pytest.mark.parametrize("mode", MODES)
def test_affine_api_matches_reference(mode, kind):
    q, s = _pair(kind, len(kind))
    assert pt.align_score(q, s, mode, SC, device="cpu") == \
        anyseq_tpu.align_score(q, s, mode, JSC)
    full = pt.align_full_tb(q, s, mode, SC, device="cpu")
    assert _astuple(full) == \
        _astuple(anyseq_tpu.align_full_tb(q, s, mode, JSC))
    mm = pt.align(q, s, mode, SC, traceback="hirschberg", device="cpu")
    assert _astuple(mm) == \
        _astuple(align_hirschberg(q, s, mode, JSC, min_width=256))
    assert rescore_affine(mm, SC) == mm.score == full.score


@pytest.mark.parametrize("mode", MODES)
def test_affine_auto_routes_like_reference(mode):
    """traceback="auto": full traceback up to 2^22 cells, Myers-Miller
    above (2100 x 2100 > 2^22)."""
    rng = np.random.default_rng(21)
    q = random_dna(rng, 2100)
    s = (mutate(rng, q) + random_dna(rng, 2100))[:2100]
    got = pt.align(q, s, mode, SC, device="cpu")
    assert _astuple(got) == _astuple(anyseq_tpu.align(q, s, mode, JSC))
    assert rescore_affine(got, SC) == got.score


@pytest.mark.parametrize("min_width", [256, 16])
def test_gap_crossing_cuts(min_width, monkeypatch):
    """Free extension forces a long horizontal run across the subject
    cuts (the case the E columns and the crossing flags exist for); at
    min_width 16 the levels also run batched (P > 2) with mixed flags."""
    sc = (1, -6, -4, 0)
    rng = np.random.default_rng(18)
    q = random_dna(rng, 300)
    s = q[:100] + random_dna(rng, 600) + q[100:]
    monkeypatch.setattr(hirschberg, "MIN_WIDTH", min_width)
    for mode in MODES:
        got = pt.align(q, s, mode, pt.AffineScoring(*sc),
                       traceback="hirschberg", device="cpu")
        want = align_hirschberg(q, s, mode, anyseq_tpu.AffineScoring(*sc),
                                min_width=min_width)
        assert _astuple(got) == _astuple(want)
        assert rescore_affine(got, pt.AffineScoring(*sc)) == got.score


@pytest.mark.parametrize("sc", [(2, -3, -5, -1), (1, -1, -2, -2)], ids=str)
def test_deep_levels_match_reference(sc, monkeypatch):
    """Myers-Miller with many batched levels (min_width 16) on a related
    and a transposed pair, all modes."""
    rng = np.random.default_rng(17)
    q = random_dna(rng, 100)
    s = mutate(rng, random_dna(rng, 170))
    monkeypatch.setattr(hirschberg, "MIN_WIDTH", 16)
    for a, b in ((q, s), (s, q)):
        for mode in MODES:
            got = pt.align(a, b, mode, pt.AffineScoring(*sc),
                           traceback="hirschberg", device="cpu")
            want = align_hirschberg(a, b, mode, anyseq_tpu.AffineScoring(*sc),
                                    min_width=16)
            assert _astuple(got) == _astuple(want)


@pytest.mark.parametrize("mode", MODES)
def test_affine_degenerate_shapes(mode):
    for q, s in ((b"A", b"ACGTACGT"), (b"ACGTTGCA" * 40, b"G"),
                 (b"AAAA", b"CCCC"), (b"ACGT" * 80, b"ACGT" * 80)):
        assert _astuple(pt.align(q, s, mode, SC, traceback="hirschberg",
                                 device="cpu")) == \
            _astuple(align_hirschberg(q, s, mode, JSC, min_width=256))
        assert _astuple(pt.align_full_tb(q, s, mode, SC, device="cpu")) == \
            _astuple(anyseq_tpu.align_full_tb(q, s, mode, JSC))


@pytest.mark.parametrize("mode", MODES)
def test_affine_scoring_carried_across(mode):
    ref = anyseq_tpu.AffineScoring(3, -2, -4, -2)
    sc = pt.scoring_from_reference(ref)
    assert sc == pt.AffineScoring(3, -2, -4, -2)
    rng = np.random.default_rng(4)
    q = random_dna(rng, 300)
    s = mutate(rng, q)
    assert pt.align_score(q, s, mode, sc, device="cpu") == \
        anyseq_tpu.align_score(q, s, mode, ref)
    assert _astuple(pt.align(q, s, mode, sc, traceback="hirschberg",
                             device="cpu")) == \
        _astuple(align_hirschberg(q, s, mode, ref, min_width=256))
