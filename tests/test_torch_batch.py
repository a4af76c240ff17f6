"""The port's batch path on the CPU (the plain K7 sweep, its extraction,
``align_scores_batch`` and ``align_batch``) against the JAX package on
XLA:CPU: its swarm kernel in interpret mode, its batched XLA sweeps and
its batch API. Every comparison is exact (int32 scores and cells, bytes
of strings)."""
import dataclasses
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anyseq_tpu
import anyseq_tpu_torch as pt
from anyseq_tpu.engine import batch as jax_batch
from anyseq_tpu.kernels import swarm as jax_swarm
from anyseq_tpu_torch.engine import batch
from anyseq_tpu_torch.engine.affine import unpack_codes4
from anyseq_tpu_torch.engine.linmem import unpack_codes
from anyseq_tpu_torch.kernels import _build, swarm

from conftest import mutate, random_dna

SCHEMES = {"linear": (2, -1, -1), "wide": (3, -2, -2),
           "affine": (2, -1, -3, -1)}
MODES = ["global", "semiglobal", "local"]


def _scorings(name):
    params = SCHEMES[name]
    if len(params) == 4:
        return anyseq_tpu.AffineScoring(*params), pt.AffineScoring(*params)
    return anyseq_tpu.LinearScoring(*params), pt.LinearScoring(*params)


def _batch(rng, B, M, N):
    """Random problems whose bytes past each length are real bases too."""
    q = rng.integers(65, 69, (B, M)).astype(np.uint8)
    s = rng.integers(65, 69, (B, N)).astype(np.uint8)
    ms = rng.integers(1, M + 1, B).astype(np.int32)
    ns = rng.integers(1, N + 1, B).astype(np.int32)
    return q, s, ms, ns


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _pairs(rng, count, lo=5, hi=120):
    qs = [random_dna(rng, int(rng.integers(lo, hi))) for _ in range(count)]
    return qs, [mutate(rng, q) for q in qs]


def _within(a, lengths):
    """Rows of a (B, L) array cut to their lengths."""
    return [row[:n].tolist() for row, n in zip(np.asarray(a), lengths)]


@pytest.mark.parametrize("scheme,mode,sgaps", [
    ("linear", "local", False), ("affine", "semiglobal", False),
    ("affine", "global", True)], ids=["linear-local", "affine-semiglobal",
                                      "affine-global-sgaps"])
def test_plain_k7_matches_swarm_kernel(scheme, mode, sgaps):
    """The plain K7 against the JAX package's Pallas swarm kernel in
    interpret mode: last rows and columns within each problem's lengths,
    best, and the extracted scores and end cells."""
    rng = np.random.default_rng(7)
    B, M, N = 21, 40, 36
    q, s, ms, ns = _batch(rng, B, M, N)
    sg = rng.integers(0, 2, B).astype(bool) if sgaps else None
    jsc, sc = _scorings(scheme)
    want = jax_swarm.score_pairs_swarm(q, s, ms, ns, mode, jsc, sgaps=sg,
                                       interpret=True)
    got = batch.swarm_batch(*_t(q, s, ms, ns), mode, sc,
                            None if sg is None else torch.from_numpy(sg))
    assert _within(got["last_rows"], ns) == _within(want["last_rows"], ns)
    assert _within(got["last_cols"], ms) == _within(want["last_cols"], ms)
    assert got["best"].tolist() == np.asarray(want["best"]).tolist()
    jscore, jend = jax_swarm.extract_batch(
        {k: jnp.asarray(v) for k, v in want.items()}, jnp.asarray(ms),
        jnp.asarray(ns), anyseq_tpu.Mode(mode))
    score, end = batch.extract_batch(got, *_t(ms, ns), mode)
    assert score.tolist() == np.asarray(jscore).tolist()
    assert end.tolist() == np.asarray(jend).tolist()


@pytest.mark.parametrize("scheme", ["linear", "wide"])
@pytest.mark.parametrize("mode", MODES)
def test_plain_k7_matches_xla_sweeps(mode, scheme):
    """Scores and LOCAL end cells against ``_score_batch`` /
    ``_score_batch_semiglobal``; codes, last rows and last columns against
    ``preds_batch_full``."""
    rng = np.random.default_rng(11)
    B, M, N = 17, 45, 60
    q, s, ms, ns = _batch(rng, B, M, N)
    jsc, sc = _scorings(scheme)
    jm = anyseq_tpu.Mode(mode)
    args = [jnp.asarray(a, jnp.int32) for a in (q, s, ms, ns)]
    got = batch.swarm_batch(*_t(q, s, ms, ns), mode, sc, emit_preds=True)
    score, end = batch.extract_batch(got, *_t(ms, ns), mode)
    if mode == "semiglobal":
        want = jax_batch._score_batch_semiglobal(*args, jm, jsc)
    else:
        want, want_end = jax_batch._score_batch(*args, jm, jsc)
        if mode == "local":
            assert end.tolist() == np.asarray(want_end).tolist()
    assert score.tolist() == np.asarray(want).tolist()
    preds, last_row, last_col, _ = jax_batch.preds_batch_full(*args, jm, jsc)
    codes = unpack_codes(got["preds"], N).numpy()
    preds = np.asarray(preds)
    for b in range(B):
        m, n = ms[b], ns[b]
        assert (codes[b, :m, :n] == preds[b, :m, :n]).all()
    live = ((np.arange(M)[None, :, None] < ms[:, None, None])
            & (np.arange(N)[None, None, :] < ns[:, None, None]))
    assert (codes[~live] == 0).all()
    assert _within(got["last_rows"], ns) == _within(last_row, ns)
    assert _within(got["last_cols"], ms) == _within(last_col, ms)


@pytest.mark.parametrize("mode", MODES)
def test_plain_k7_affine_matches_xla_sweep(mode):
    rng = np.random.default_rng(12)
    q, s, ms, ns = _batch(rng, 15, 50, 44)
    jsc, sc = _scorings("affine")
    want = jax_batch._score_batch_affine(
        *[jnp.asarray(a, jnp.int32) for a in (q, s, ms, ns)],
        anyseq_tpu.Mode(mode), jsc)
    got = batch.swarm_batch(*_t(q, s, ms, ns), mode, sc)
    assert batch.extract_batch(got, *_t(ms, ns), mode)[0].tolist() == \
        np.asarray(want).tolist()


def test_plain_k7_pads_are_inert():
    """Bytes past a problem's lengths are real bases; changing them
    changes no output."""
    rng = np.random.default_rng(13)
    q, s, ms, ns = _batch(rng, 12, 30, 30)
    for name in SCHEMES:
        sc = _scorings(name)[1]
        for mode in MODES:
            outs = []
            for base in (65, 67):
                qq, ss_ = q.copy(), s.copy()
                qq[np.arange(30)[None, :] >= ms[:, None]] = base
                ss_[np.arange(30)[None, :] >= ns[:, None]] = base
                outs.append(batch.swarm_batch(
                    *_t(qq, ss_, ms, ns), mode, sc,
                    emit_preds=len(SCHEMES[name]) == 3))
            for k in outs[0]:
                assert torch.equal(outs[0][k], outs[1][k]), (name, mode, k)


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("mode", MODES)
def test_align_scores_batch_matches_reference(mode, scheme):
    rng = np.random.default_rng(21)
    qs, ss = _pairs(rng, 30)
    qs.append(b"A")
    ss.append(b"A")
    jsc, sc = _scorings(scheme)
    want = anyseq_tpu.align_scores_batch(qs, ss, mode, jsc, engine="xla")
    got = pt.align_scores_batch(qs, ss, mode, sc, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def _astuples(alns):
    return [dataclasses.astuple(a) for a in alns]


@pytest.mark.parametrize("mode", MODES)
def test_align_batch_matches_reference(mode):
    """Scores, starts and both strings, with the all-mismatch pairs (LOCAL:
    score 0, no walk, start = end + 1; SEMIGLOBAL: end (m-1, -1), a dead
    walk, start (m, 0)) and a 1 x 1 pair."""
    rng = np.random.default_rng(22)
    qs, ss = _pairs(rng, 16, 5, 90)
    qs += [b"AAAAAA", b"G", b"ACGT"]
    ss += [b"CCCCCC", b"G", b"T"]
    jsc, sc = _scorings("linear")
    want = anyseq_tpu.align_batch(qs, ss, mode, jsc, engine="xla")
    got = pt.align_batch(qs, ss, mode, sc, device="cpu")
    assert _astuples(got) == _astuples(want)
    assert all(isinstance(a, pt.Alignment) for a in got)


def test_all_mismatch_pairs():
    q, s = b"AAAAAA", b"CCCCCC"
    local = pt.align_batch([q], [s], "local", device="cpu")[0]
    assert (local.score, local.start) == (0, (1, 1))
    assert local.query_aligned == local.subject_aligned == b" " * 12
    semi = pt.align_batch([q], [s], "semiglobal", device="cpu")[0]
    assert (semi.score, semi.start) == (0, (6, 0))
    assert semi.query_aligned == semi.subject_aligned == b" " * 12
    res = batch.swarm_batch(*_t(np.array([list(q)], np.uint8),
                                np.array([list(s)], np.uint8),
                                np.array([6]), np.array([6])),
                            "semiglobal", pt.LinearScoring(), emit_preds=True)
    score, end = batch.extract_batch(res, torch.tensor([6]),
                                     torch.tensor([6]), "semiglobal")
    assert (score.tolist(), end.tolist()) == ([0], [[5, -1]])


def test_semiglobal_dead_walk_matches_xla_walk():
    """The walk from the extracted SEMIGLOBAL ends, some on the j = -1
    boundary, against the JAX package's ``walk_batch_ends``."""
    rng = np.random.default_rng(23)
    q, s, ms, ns = _batch(rng, 10, 20, 24)
    q[:3] = 65                          # all-mismatch problems
    s[:3] = 67
    res = batch.swarm_batch(*_t(q, s, ms, ns), "semiglobal",
                            pt.LinearScoring(), emit_preds=True)
    _, end = batch.extract_batch(res, *_t(ms, ns), "semiglobal")
    assert (end[:3, 1] == -1).all()
    got = batch.walk_batch_ends(res["preds"], *_t(q, s), end, "semiglobal")
    dense = unpack_codes(res["preds"], 24).numpy()
    want = jax_batch.walk_batch_ends(
        jnp.asarray(dense), jnp.asarray(q, jnp.int32),
        jnp.asarray(s, jnp.int32), jnp.asarray(ms), jnp.asarray(ns),
        jnp.asarray(end.numpy()), anyseq_tpu.Mode.SEMIGLOBAL)
    L = 20 + 24
    assert got[0].tolist() == np.asarray(want[0])[:, :L].tolist()
    assert got[1].tolist() == np.asarray(want[1])[:, :L].tolist()
    assert got[2].tolist() == np.asarray(want[2]).tolist()


@pytest.mark.parametrize("mode", MODES)
def test_affine_align_batch_is_per_pair(mode):
    rng = np.random.default_rng(24)
    qs, ss = _pairs(rng, 5, 5, 60)
    sc = pt.AffineScoring(2, -1, -3, -1)
    got = pt.align_batch(qs, ss, mode, sc, device="cpu")
    want = [pt.align(a, b, mode, sc, device="cpu") for a, b in zip(qs, ss)]
    assert _astuples(got) == _astuples(want)


@pytest.mark.parametrize("fn", ["align_scores_batch", "align_batch"])
def test_mixed_buckets_keep_input_order(fn):
    """Related pairs around 256 bp straddle the 256 / 512 bucket edge:
    several buckets in one call, results in input order."""
    rng = np.random.default_rng(25)
    qs = [random_dna(rng, int(rng.integers(240, 270))) for _ in range(8)]
    ss = [mutate(rng, q) for q in qs]
    qs += [b"GATTACA", b"ACGT" * 70]
    ss += [b"GATTTACA" * 40, b"ACG"]
    buckets = {(len(a) > 256, len(b) > 256) for a, b in zip(qs, ss)}
    assert len(buckets) >= 3
    jsc, sc = _scorings("linear")
    got = getattr(pt, fn)(qs, ss, "local", sc, device="cpu")
    want = getattr(anyseq_tpu, fn)(qs, ss, "local", jsc, engine="xla")
    if fn == "align_batch":
        got, want = _astuples(got), _astuples(want)
    else:
        got, want = got.tolist(), want.tolist()
    assert got == want


@pytest.mark.parametrize("mode", MODES)
def test_align_batch_builds_plain_alignments(mode):
    """align_batch's Alignments, built in bulk, against ones built by the
    dataclass's own constructor from the same values: mixed buckets,
    pairs shorter than their bucket and one that fills it, and LOCAL
    pairs scoring <= 0 (no walk, start = end + 1). The same type, fields, ==, hash, repr and
    compact(), and frozen."""
    rng = np.random.default_rng(28)
    qs = [random_dna(rng, int(rng.integers(240, 270))) for _ in range(5)]
    ss = [mutate(rng, q) for q in qs]
    qs += [b"AAAAAA", b"TTT", b"GATTACA", b"ACGT" * 70, b"G"]
    ss += [b"CCCCCC", b"GG", b"GATTTACA" * 40, b"ACG", b"T"]
    qs.append(random_dna(rng, 256))         # m + n fills its bucket
    ss.append(random_dna(rng, 256))
    got = pt.align_batch(qs, ss, mode, device="cpu")
    assert type(got) is list and len(got) == len(qs)
    if mode == "local":
        assert [a.score for a in got[5:7]] == [0, 0]
        assert [a.start for a in got[5:7]] == [(1, 1), (1, 1)]
    for a, q, s in zip(got, qs, ss):
        assert type(a) is pt.Alignment
        assert type(a.score) is int and type(a.start) is tuple
        assert [type(x) for x in a.start] == [int, int]
        assert type(a.query_aligned) is type(a.subject_aligned) is bytes
        assert len(a.query_aligned) == len(a.subject_aligned) == \
            len(q) + len(s)
        want = pt.Alignment(int(a.score), bytes(a.query_aligned),
                            bytes(a.subject_aligned),
                            (int(a.start[0]), int(a.start[1])))
        for f in dataclasses.fields(pt.Alignment):
            assert getattr(a, f.name) == getattr(want, f.name)
        assert a == want and hash(a) == hash(want)
        assert repr(a) == repr(want) and a.compact() == want.compact()
        for f in dataclasses.fields(pt.Alignment):
            with pytest.raises(dataclasses.FrozenInstanceError):
                setattr(a, f.name, getattr(want, f.name))
        with pytest.raises(dataclasses.FrozenInstanceError):
            del a.score


@pytest.mark.parametrize("fails", [False, True], ids=["returns", "raises"])
@pytest.mark.parametrize("enabled", [True, False], ids=["gc-on", "gc-off"])
def test_align_batch_restores_the_collector(monkeypatch, enabled, fails):
    """The cyclic collector is off while a chunk's Alignments are built,
    and afterwards as the caller left it, also where the build raises."""
    seen = []

    def build(*args):
        seen.append(gc.isenabled())
        if fails:
            raise RuntimeError("build failed")
        return bulk(*args)

    bulk = batch._alignments
    monkeypatch.setattr(batch, "_alignments", build)
    qs, ss = _pairs(np.random.default_rng(29), 6)
    qs.append(b"ACGT" * 80)                 # a second bucket: two chunks
    ss.append(b"ACG")
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        if fails:
            with pytest.raises(RuntimeError, match="build failed"):
                pt.align_batch(qs, ss, "local", device="cpu")
        else:
            got = pt.align_batch(qs, ss, "local", device="cpu")
            assert _astuples(got) == _astuples(
                [pt.align_batch([q], [s], "local", device="cpu")[0]
                 for q, s in zip(qs, ss)])
        assert gc.isenabled() is enabled
    finally:
        (gc.enable if was else gc.disable)()
    assert seen[:2] == ([False] if fails else [False, False])


def test_bad_inputs_raise():
    for fn in (pt.align_scores_batch, pt.align_batch):
        with pytest.raises(ValueError, match="empty"):
            fn([b"ACGT", b""], [b"ACGT", b"AC"], device="cpu")
        with pytest.raises(ValueError, match="equal length"):
            fn([b"ACGT"], [b"ACGT", b"AC"], device="cpu")
        assert len(fn([], [], device="cpu")) == 0
    # a mesh of another type is refused (mesh= itself runs:
    # tests/test_torch_dist_construct.py)
    with pytest.raises(TypeError, match="Mesh"):
        pt.align_batch([b"ACGT"], [b"ACGT"], mesh=object(), device="cpu")
    # K7's affine codes run: 8 four-bit codes a word
    res = swarm.score_pairs_swarm(*_t(*_batch(np.random.default_rng(0), 2, 4,
                                              9)), "global",
                                  pt.AffineScoring(), emit_preds=True)
    assert res["preds"].shape == (2, 4, 2)


@pytest.mark.parametrize("mode", MODES)
def test_plain_k7_affine_codes_match_swarm_kernel(mode):
    """K7's affine 4-bit codes (the plain version) against the JAX
    package's swarm kernel in interpret mode (score_pairs_swarm_preds):
    the dense codes of every cell within each problem's lengths, mixed
    start-gap flags. At this scoring (gap_open and gap_extend both < 0)
    they are equal everywhere; where one of them is 0 they differ in
    column 0 of start-gap problems (test_plain_k7_affine_codes_column0)."""
    rng = np.random.default_rng(8)
    B, M, N = 19, 30, 40
    q, s, ms, ns = _batch(rng, B, M, N)
    sg = rng.integers(0, 2, B).astype(bool)
    jsc, sc = _scorings("affine")
    want = np.asarray(jax_swarm.score_pairs_swarm_preds(
        q, s, ms, ns, mode, jsc, sgaps=sg, interpret=True)["preds"])
    got = swarm.score_pairs_swarm(*_t(q, s, ms, ns), mode, sc,
                                  torch.from_numpy(sg), emit_preds=True)
    codes = unpack_codes4(got["preds"], N).numpy()
    for b in range(B):
        np.testing.assert_array_equal(codes[b, :ms[b], :ns[b]],
                                      want[b, :ms[b], :ns[b]])
    # nothing past a problem's lengths
    assert not codes[0, ms[0]:].any() and not codes[0, :, ns[0]:].any()



@pytest.mark.parametrize("params", [(1, -6, -4, 0), (2, -1, 0, -1)],
                         ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_plain_k7_affine_codes_column0(mode, params):
    """Where gap_open or gap_extend is 0, K7's affine codes keep the JAX
    package's user path and leave its swarm kernel in one place. K7 (the
    plain version) starts E[i][-1] of a start-gap problem at
    NEG + go - ge; the XLA pred sweep of the Myers-Miller terminal
    stripes (preds_batch_affine) gives the same codes, GLOBAL, everywhere.
    The swarm kernel (score_pairs_swarm_preds, interpret mode) starts
    that E at NEG, so its PE bit (bit 2) of column 0 differs in
    start-gap GLOBAL problems, and nothing else does, in any mode."""
    rng = np.random.default_rng(9)
    B, M, N = 12, 14, 17
    q, s, ms, ns = _batch(rng, B, M, N)
    sg = rng.integers(0, 2, B).astype(bool)
    sg[:2] = True, False
    jsc, sc = (anyseq_tpu.AffineScoring(*params),
               pt.AffineScoring(*params))
    got = swarm.score_pairs_swarm(*_t(q, s, ms, ns), mode, sc,
                                  torch.from_numpy(sg), emit_preds=True)
    codes = unpack_codes4(got["preds"], N).numpy()
    kernel = np.asarray(jax_swarm.score_pairs_swarm_preds(
        q, s, ms, ns, mode, jsc, sgaps=sg, interpret=True)["preds"])
    xla = (np.asarray(jax_batch.preds_batch_affine(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(ms), jnp.asarray(ns),
        jsc, jnp.asarray(sg))[0]) if mode == "global" else None)
    differ = 0
    for b in range(B):
        mine = codes[b, :ms[b], :ns[b]]
        if xla is not None:
            np.testing.assert_array_equal(mine, xla[b, :ms[b], :ns[b]])
        diff = mine ^ kernel[b, :ms[b], :ns[b]]
        if sg[b]:
            differ += int(diff[:, 0].any())
            diff[:, 0] &= ~np.uint8(4)
        assert not diff.any(), b
    # the departure shows: GLOBAL start-gap problems differ in PE at j = 0
    assert (differ > 0) == (mode == "global")

def test_cpu_batches_launch_no_kernel():
    for k in _build.launches:
        _build.launches[k] = 0
    rng = np.random.default_rng(26)
    qs, ss = _pairs(rng, 6)
    for sc in (pt.LinearScoring(), pt.AffineScoring()):
        pt.align_scores_batch(qs, ss, "local", sc, device="cpu")
        pt.align_batch(qs, ss, "local", sc, device="cpu")
    assert set(_build.launches.values()) == {0}


@pytest.mark.parametrize("affine", [False, True], ids=["linear", "affine"])
def test_chunks_count_k7_boundary_columns(monkeypatch, affine):
    """A chunk holds as many pairs as CHUNK_BYTES gives a bucket's pairs
    with K7's boundary columns for the scoring: a 1,024 x 2,048 pair's
    strips at K7's narrowest width (linear 256 columns, 4 bytes a value;
    affine 128 columns, H and E, 8 bytes)."""
    monkeypatch.setattr(batch, "CHUNK_BYTES", 1 << 20)
    qs, ss = [b"A" * 1000] * 50, [b"C" * 2000] * 50
    sizes = [len(c[0]) for c in batch._chunks(qs, ss, batch.SCORE_CHUNK, 0,
                                              affine)]
    M, N = 1024, 2048
    strips = N // (128 if affine else 256)
    per_problem = (M + N) * 5 + (strips - 1) * M * (8 if affine else 4)
    step = (1 << 20) // per_problem
    assert step == (7 if affine else 23)
    assert sizes == [step] * (50 // step) + ([50 % step] if 50 % step else [])
    assert swarm.boundary_bytes(M, N, affine, False) == (
        (strips - 1) * M * (8 if affine else 4))
