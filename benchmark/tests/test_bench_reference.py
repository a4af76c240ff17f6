"""The plain reference against a brute-force full matrix, and the check
of constructed alignments."""
import numpy as np
import pytest

from benchmark.reference import alignment, dp

SCORINGS = [(2, -1, -1), (1, -4, -2), (3, -3, 0)]


def _pairs(rng, count, top, alphabet=b"ACGT"):
    return ([bytes(rng.choice(list(alphabet), rng.integers(1, top)))
             for _ in range(count)],
            [bytes(rng.choice(list(alphabet), rng.integers(1, top)))
             for _ in range(count)])


@pytest.mark.parametrize("mode", dp.MODES)
@pytest.mark.parametrize("scoring", SCORINGS)
@pytest.mark.parametrize("chunk,block", [(1024, 256), (3, 4), (4, 1)])
def test_reference_is_brute_force(monkeypatch, mode, scoring, chunk, block):
    """Small chunks and blocks drive the chunked prefix maximum and the
    blocks (a CUDA graph a block on the card) as a long pair does."""
    monkeypatch.setattr(dp, "SCAN_CHUNK", chunk)
    monkeypatch.setattr(dp, "BLOCK", block)
    rng = np.random.default_rng(sum(scoring) + chunk + block)
    for t in range(25):
        qs, ss = _pairs(rng, int(rng.integers(1, 5)), 13,
                        b"AC" if t % 3 == 0 else b"ACGT")
        scores, ends = dp.align_ends(qs, ss, mode, *scoring)
        for b, (q, s) in enumerate(zip(qs, ss)):
            assert (scores[b], tuple(ends[b])) == dp.brute_force(
                q, s, mode, *scoring), (q, s)


@pytest.mark.parametrize("mode", dp.MODES)
def test_reference_agrees_with_the_program_on_the_cpu(mode):
    """The documented tie rules, read off the same inputs by the port's
    CPU path (its kernels' plain versions) and by the reference."""
    import anyseq_tpu_torch as pt

    rng = np.random.default_rng(3)
    qs, ss = _pairs(rng, 40, 60)
    scores, ends = dp.align_ends(qs, ss, mode, 2, -1, -1)
    got = pt.align_batch(qs, ss, mode, device="cpu")
    assert [a.score for a in got] == scores.tolist()
    out, cols, valid = alignment.replay(
        qs, ss, [a.query_aligned for a in got],
        [a.subject_aligned for a in got], [a.start for a in got], 2, -1, -1)
    assert valid.all() and (out == scores).all()
    assert (cols == ends).all()


def _one(q, s, mode="local"):
    import anyseq_tpu_torch as pt

    return pt.align(q, s, mode, device="cpu")


def _replay(q, s, a, out_q=None, out_s=None, start=None):
    return alignment.replay([q], [s], [out_q or a.query_aligned],
                            [out_s or a.subject_aligned],
                            [start or a.start], 2, -1, -1)


def test_replay_takes_a_true_alignment():
    q, s = b"GATTACAGATTACA", b"GATTTACAGTTACA"
    a = _one(q, s)
    score, end, valid = _replay(q, s, a)
    assert valid[0] and score[0] == a.score


@pytest.mark.parametrize("fault", ["symbol", "offset", "start", "length"])
def test_replay_refutes_a_broken_alignment(fault):
    q, s = b"GATTACAGATTACA", b"GATTTACAGTTACA"
    a = _one(q, s)
    aq = bytearray(a.query_aligned)
    live = [k for k, c in enumerate(aq) if c not in b" _"]
    kw = {}
    if fault == "symbol":
        aq[live[3]] = ord("C") if aq[live[3]] != ord("C") else ord("G")
        kw["out_q"] = bytes(aq)
    elif fault == "offset":
        kw["out_q"] = bytes(aq[1:] + aq[:1])
        kw["out_s"] = a.subject_aligned[1:] + a.subject_aligned[:1]
    elif fault == "start":
        kw["start"] = (a.start[0] + 1, a.start[1])
    else:
        kw["out_q"] = bytes(aq[:-1])
    score, end, valid = _replay(q, s, a, **kw)
    assert not valid[0] or score[0] != a.score


def test_start_rules():
    st = np.array([[0, 3], [2, 2], [0, 0]])
    en = np.array([[9, 5], [9, 5], [9, 9]])
    ms, ns = np.array([10, 10, 10]), np.array([8, 8, 10])
    assert alignment.start_allowed("semiglobal", st, en, ms, ns).tolist() == [
        True, False, True]
    assert alignment.start_allowed("global", st, en, ms, ns).tolist() == [
        False, False, True]
    assert alignment.start_allowed("local", st, en, ms, ns).all()
