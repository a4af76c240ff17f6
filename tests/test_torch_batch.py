"""The port's batch path on the CPU (the plain K7 sweep, its extraction,
``align_scores_batch`` and ``align_batch``) against the JAX package on
XLA:CPU: its swarm kernel in interpret mode, its batched XLA sweeps and
its batch API. Every comparison is exact (int32 scores and cells, bytes
of strings)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anyseq_tpu
import anyseq_tpu_torch as pt
from anyseq_tpu.engine import batch as jax_batch
from anyseq_tpu.kernels import swarm as jax_swarm
from anyseq_tpu_torch.engine import batch
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


def test_bad_inputs_raise():
    for fn in (pt.align_scores_batch, pt.align_batch):
        with pytest.raises(ValueError, match="empty"):
            fn([b"ACGT", b""], [b"ACGT", b"AC"], device="cpu")
        with pytest.raises(ValueError, match="equal length"):
            fn([b"ACGT"], [b"ACGT", b"AC"], device="cpu")
        assert len(fn([], [], device="cpu")) == 0
    with pytest.raises(NotImplementedError, match="item 12"):
        pt.align_batch([b"ACGT"], [b"ACGT"], mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="K7"):
        swarm.score_pairs_swarm(*_t(*_batch(np.random.default_rng(0), 2, 4,
                                            4)), "global",
                                pt.AffineScoring(), emit_preds=True)


def test_cpu_batches_launch_no_kernel():
    for k in _build.launches:
        _build.launches[k] = 0
    rng = np.random.default_rng(26)
    qs, ss = _pairs(rng, 6)
    for sc in (pt.LinearScoring(), pt.AffineScoring()):
        pt.align_scores_batch(qs, ss, "local", sc, device="cpu")
        pt.align_batch(qs, ss, "local", sc, device="cpu")
    assert set(_build.launches.values()) == {0}
