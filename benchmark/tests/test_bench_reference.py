"""The plain reference against a brute-force full matrix, and the check
of constructed alignments, with linear and affine gaps."""
import numpy as np
import pytest

from benchmark.reference import alignment, dp

SCORINGS = [(2, -1, -1), (1, -4, -2), (3, -3, 0)]
# (match, mismatch, gap_open, gap_extend): bwa mem's defaults, the affine
# 2/-1/-3/-1 of a long-pair construction, no extension, no opening
AFFINE_SCORINGS = [(1, -4, -6, -1), (2, -1, -3, -1), (2, -3, -4, 0),
                   (2, -1, 0, -2)]
BLOCKS = [(1024, 256), (3, 4), (4, 1)]


def _pairs(rng, count, top, alphabet=b"ACGT"):
    return ([bytes(rng.choice(list(alphabet), rng.integers(1, top)))
             for _ in range(count)],
            [bytes(rng.choice(list(alphabet), rng.integers(1, top)))
             for _ in range(count)])


@pytest.mark.parametrize("mode", dp.MODES)
@pytest.mark.parametrize("scoring", SCORINGS)
@pytest.mark.parametrize("chunk,block", BLOCKS)
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
@pytest.mark.parametrize("scoring", AFFINE_SCORINGS)
@pytest.mark.parametrize("chunk,block", BLOCKS)
def test_affine_reference_is_brute_force(monkeypatch, mode, scoring, chunk,
                                         block):
    """Gotoh's three full matrices, at the chunks and blocks of the linear
    test."""
    monkeypatch.setattr(dp, "SCAN_CHUNK", chunk)
    monkeypatch.setattr(dp, "BLOCK", block)
    rng = np.random.default_rng(sum(scoring) + chunk + block + 100)
    for t in range(25):
        qs, ss = _pairs(rng, int(rng.integers(1, 5)), 13,
                        b"AC" if t % 3 == 0 else b"ACGT")
        scores, ends = dp.align_ends_affine(qs, ss, mode, *scoring)
        for b, (q, s) in enumerate(zip(qs, ss)):
            assert (scores[b], tuple(ends[b])) == dp.brute_force_affine(
                q, s, mode, *scoring), (q, s)


@pytest.mark.parametrize("mode", dp.MODES)
def test_affine_without_opening_is_linear(mode):
    """gap_open 0 is the linear gap gap_extend: the same scores and end
    cells, tie rules included, on pairs long enough for several chunks."""
    rng = np.random.default_rng(11)
    qs, ss = _pairs(rng, 30, 200)
    for match, mismatch, gap in SCORINGS:
        linear = dp.align_ends(qs, ss, mode, match, mismatch, gap)
        affine = dp.align_ends_affine(qs, ss, mode, match, mismatch, 0, gap)
        assert (linear[0] == affine[0]).all()
        assert (linear[1] == affine[1]).all()


@pytest.mark.parametrize("mode", dp.MODES)
@pytest.mark.parametrize("scoring", AFFINE_SCORINGS[:2])
def test_affine_reference_agrees_with_the_program_on_the_cpu(mode, scoring):
    """The port's affine path on the CPU against the affine reference:
    scores, the documented end cells, and every alignment valid under the
    affine replay, adding up to the optimum."""
    import anyseq_tpu_torch as pt

    rng = np.random.default_rng(4)
    qs, ss = _pairs(rng, 24, 60)
    # related pairs too, whose alignments hold gap runs
    for _ in range(12):
        q = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(rng.integers(20, 60)))].tobytes()
        cut = sorted(rng.choice(len(q), 2, replace=False))
        qs.append(q)
        ss.append(q[:cut[0]] + b"TTG" + q[cut[0]:cut[1]] + q[cut[1] + 2:])
    scores, ends = dp.align_ends_affine(qs, ss, mode, *scoring)
    got = pt.align_batch(qs, ss, mode, pt.AffineScoring(*scoring),
                         device="cpu")
    assert [a.score for a in got] == scores.tolist()
    match, mismatch, gap_open, gap_extend = scoring
    out, cols, valid = alignment.replay(
        qs, ss, [a.query_aligned for a in got],
        [a.subject_aligned for a in got], [a.start for a in got], match,
        mismatch, gap_extend, gap_open=gap_open)
    assert valid.all() and (out == scores).all()
    assert (cols == ends).all()


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


# (match, mismatch, gap) or (match, mismatch, gap_open, gap_extend)
KINDS = {"linear": (2, -1, -1), "affine": (2, -1, -3, -1)}


def _one(q, s, mode="local", kind="linear"):
    import anyseq_tpu_torch as pt

    sc = KINDS[kind]
    scoring = (pt.LinearScoring(*sc) if kind == "linear"
               else pt.AffineScoring(*sc))
    return pt.align(q, s, mode, scoring, device="cpu")


def _replay(q, s, a, out_q=None, out_s=None, start=None, kind="linear"):
    sc = KINDS[kind]
    gaps = sc[2:] if kind == "linear" else (sc[3], "cpu", sc[2])
    return alignment.replay([q], [s], [out_q or a.query_aligned],
                            [out_s or a.subject_aligned],
                            [start or a.start], sc[0], sc[1], *gaps)


@pytest.mark.parametrize("kind", KINDS)
def test_replay_takes_a_true_alignment(kind):
    q, s = b"GATTACAGATTACA", b"GATTTACAGTTACA"
    a = _one(q, s, kind=kind)
    score, end, valid = _replay(q, s, a, kind=kind)
    assert valid[0] and score[0] == a.score


def _columns(cols: str, m: int, n: int):
    """The library's buffers of an alignment from (0, 0), given its
    columns as "qs qs ..." pairs of symbols ('_' for a gap)."""
    aq, as_ = bytearray(b" " * (m + n)), bytearray(b" " * (m + n))
    i = j = -1
    for qc, sc in cols.split():
        i, j = i + (qc != "_"), j + (sc != "_")
        aq[i + j + 1], as_[i + j + 1] = ord(qc), ord(sc)
    return bytes(aq), bytes(as_)


def test_replay_counts_gap_runs():
    """A run of two subject symbols against query gaps, split in two by a
    match: the same columns, one opening more. Linear replay scores both
    alike; affine replay holds the split one to its own, lower, score."""
    q, s = b"ATA", b"ATTTA"
    merged = _columns("AA TT _T _T AA", 3, 5)
    split = _columns("AA _T TT _T AA", 3, 5)
    adjacent = _columns("AA TT _T _T A_ _A", 3, 5)
    args = ([q] * 3, [s] * 3, [merged[0], split[0], adjacent[0]],
            [merged[1], split[1], adjacent[1]], [(0, 0)] * 3, 2, -1, -1)
    linear = alignment.replay(*args)
    affine = alignment.replay(*args, gap_open=-3)
    assert linear[2].all() and affine[2].all()
    assert linear[0].tolist() == [4, 4, 0]
    # one run of 2; two runs of 1; a subject gap beside a query gap: 3 runs
    assert affine[0].tolist() == [4 - 3, 4 - 6, 0 - 9]
    assert (dp.brute_force_affine(q, s, "global", 2, -1, -3, -1)[0]
            == affine[0][0])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fault", ["symbol", "offset", "start", "length"])
def test_replay_refutes_a_broken_alignment(fault, kind):
    q, s = b"GATTACAGATTACA", b"GATTTACAGTTACA"
    a = _one(q, s, kind=kind)
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
    score, end, valid = _replay(q, s, a, kind=kind, **kw)
    assert not valid[0] or score[0] != a.score


def test_affine_replay_refutes_a_split_run():
    """The program's optimal affine alignment with one gap run split in two
    (the columns' symbols and offsets all still consume the sequences):
    valid, but not adding up to the program's score."""
    q, s = b"ATA", b"ATTTA"
    a = _one(q, s, "global", "affine")
    assert a.score == 6 - 3 - 2
    score, end, valid = _replay(q, s, a, *_columns("AA _T TT _T AA", 3, 5),
                                kind="affine")
    assert valid[0] and score[0] == 6 - 6 - 2 != a.score


def test_start_rules():
    st = np.array([[0, 3], [2, 2], [0, 0]])
    en = np.array([[9, 5], [9, 5], [9, 9]])
    ms, ns = np.array([10, 10, 10]), np.array([8, 8, 10])
    assert alignment.start_allowed("semiglobal", st, en, ms, ns).tolist() == [
        True, False, True]
    assert alignment.start_allowed("global", st, en, ms, ns).tolist() == [
        False, False, True]
    assert alignment.start_allowed("local", st, en, ms, ns).all()
