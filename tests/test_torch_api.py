"""The port's public API on the CPU (every kernel's plain version) against
the JAX package on XLA:CPU, and against the golden corpus: scores, end and
start cells, and the aligned byte strings must be equal."""
import dataclasses
import json
import os

import numpy as np
import pytest

import anyseq_tpu
import anyseq_tpu_torch as pt
from anyseq_tpu.engine.hirschberg import align_hirschberg

from conftest import mutate, random_dna
from terminal_cases import TERMINAL_KINDS, terminal_pair

MODES = ["global", "semiglobal", "local"]
SC = pt.LinearScoring(2, -1, -1)
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
with open(os.path.join(GOLDEN_DIR, "golden.json")) as f:
    GOLDEN = json.load(f)


def _pair(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "related":
        q = random_dna(rng, 900)
        return q, mutate(rng, q, 0.15, 0.08)
    if kind == "unrelated":
        return random_dna(rng, 500), random_dna(rng, 640)
    if kind == "skewed":
        q = random_dna(rng, 120)
        return q, random_dna(rng, 400) + mutate(rng, q) + random_dna(rng, 500)
    if kind == "gappy":
        q = random_dna(rng, 700)
        return q, q[:200] + q[450:]
    raise ValueError(kind)


def _astuple(aln):
    return dataclasses.astuple(aln)


@pytest.mark.parametrize("kind", ["related", "unrelated", "skewed", "gappy"])
@pytest.mark.parametrize("mode", MODES)
def test_api_matches_reference(mode, kind):
    q, s = _pair(kind, len(kind))
    assert pt.align_score(q, s, mode, device="cpu") == \
        anyseq_tpu.align_score(q, s, mode)
    assert _astuple(pt.align_full_tb(q, s, mode, device="cpu")) == \
        _astuple(anyseq_tpu.align_full_tb(q, s, mode))
    assert _astuple(pt.align(q, s, mode, traceback="hirschberg",
                             device="cpu")) == \
        _astuple(align_hirschberg(q, s, mode, min_width=256))


@pytest.mark.parametrize("kind", TERMINAL_KINDS)
def test_hirschberg_terminal_stripes(kind, monkeypatch):
    """Linear constructions whose terminal stripes fall in several padded
    shapes, or whose root is itself a stripe (one of one row), on CPU
    tensors: the JAX package's strings and score. The stripes' bounds
    reach the sweep from the host; on the CPU the plain row loop sweeps
    them, and the ``hirschberg.terminals`` span counts no K7 stripe."""
    from anyseq_tpu_torch.utils import profiling

    q, s, mode = terminal_pair(kind)
    monkeypatch.setenv("ANYSEQ_TIMING", "1")
    profiling.clear()
    got = pt.align(q, s, mode, SC, traceback="hirschberg", device="cpu")
    spans = profiling.spans()
    profiling.clear()
    assert _astuple(got) == _astuple(align_hirschberg(q, s, mode,
                                                      min_width=256))
    (phase,) = [x for x in spans if x.name == "hirschberg.terminals"]
    chunks = [x for x in spans if x.name == "hirschberg.terminal_chunk"]
    assert phase.attrs["stripes"] == sum(c.attrs["stripes"] for c in chunks)
    assert phase.attrs["k7_stripes"] == 0
    if kind == "two buckets":
        assert len(chunks) == 2


@pytest.mark.parametrize("mode", MODES)
def test_auto_routes_like_reference(mode):
    """traceback="auto": full traceback up to 2^22 cells, Hirschberg above
    (2100 x 2100 > 2^22)."""
    rng = np.random.default_rng(9)
    q = random_dna(rng, 150)
    s = mutate(rng, q)
    assert _astuple(pt.align(q, s, mode, device="cpu")) == \
        _astuple(anyseq_tpu.align(q, s, mode))
    q = random_dna(rng, 2100)
    s = (mutate(rng, q) + random_dna(rng, 2100))[:2100]
    assert _astuple(pt.align(q, s, mode, device="cpu")) == \
        _astuple(anyseq_tpu.align(q, s, mode))


@pytest.mark.parametrize("mode", MODES)
def test_scoring_carried_across(mode):
    ref = anyseq_tpu.LinearScoring(3, -2, -2)
    rng = np.random.default_rng(4)
    q = random_dna(rng, 400)
    s = mutate(rng, q)
    sc = pt.scoring_from_reference(ref)
    assert pt.align_score(q, s, mode, sc, device="cpu") == \
        anyseq_tpu.align_score(q, s, mode, ref)
    assert _astuple(pt.align(q, s, mode, sc, traceback="hirschberg",
                             device="cpu")) == \
        _astuple(align_hirschberg(q, s, mode, ref, min_width=256))


@pytest.mark.parametrize("mode", MODES)
def test_degenerate_shapes(mode):
    for q, s in ((b"A", b"ACGTACGT"), (b"ACGTTGCA" * 40, b"G"),
                 (b"AAAA", b"CCCC"), (b"ACGT" * 80, b"ACGT" * 80)):
        assert _astuple(pt.align(q, s, mode, traceback="hirschberg",
                                 device="cpu")) == \
            _astuple(align_hirschberg(q, s, mode, min_width=256))
        assert _astuple(pt.align_full_tb(q, s, mode, device="cpu")) == \
            _astuple(anyseq_tpu.align_full_tb(q, s, mode))


def _read_pairs(path):
    seqs, cur = [], []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                    cur = []
            else:
                cur.append(line.strip())
    if cur:
        seqs.append("".join(cur))
    return [(seqs[i].encode(), seqs[i + 1].encode())
            for i in range(0, len(seqs) - 1, 2)]


def _classes():
    return [pytest.param(c, id=c["fasta"]) for c in GOLDEN["classes"]]


@pytest.mark.parametrize("cls", _classes())
def test_golden_scores(cls):
    pairs = _read_pairs(os.path.join(GOLDEN_DIR, cls["fasta"]))
    for rec in cls["pairs"]:
        q, s = pairs[rec["k"]]
        for name, want in rec["scores"].items():
            assert pt.align_score(q, s, name, SC, device="cpu") == want, \
                (cls["fasta"], rec["k"], name)


@pytest.mark.parametrize("cls", _classes())
def test_golden_alignments(cls):
    """Full-traceback strings byte for byte where the corpus has them, and
    the Hirschberg score of pair 0 of each class."""
    pairs = _read_pairs(os.path.join(GOLDEN_DIR, cls["fasta"]))
    for rec in cls["pairs"]:
        q, s = pairs[rec["k"]]
        for name, want in (rec["alignments"] or {}).items():
            aln = pt.align_full_tb(q, s, name, SC, device="cpu")
            assert aln.compact() == (want["q"], want["s"]), \
                (cls["fasta"], rec["k"], name)
    rec = cls["pairs"][0]
    q, s = pairs[rec["k"]]
    if len(q) * len(s) <= 16_000_000:
        for name, want in rec["scores"].items():
            aln = pt.align(q, s, name, SC, traceback="hirschberg",
                           device="cpu")
            assert aln.score == want, (cls["fasta"], name)
