"""The port's affine (Gotoh) engines against the JAX package on XLA:CPU:
the single-pair sweep (plain version of K5/K5p), the batched level sweep
(plain K5L), the terminal-stripe pred sweep, the 3-state walk (plain K6)
and the Myers-Miller merge. int32 DP, so every output must be equal --
no tolerance."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anyseq_tpu.core.types import AffineScoring as JaxAffine
from anyseq_tpu.core.types import Mode as JaxMode
from anyseq_tpu.engine import api as jax_api
from anyseq_tpu.engine import batch as jax_batch
from anyseq_tpu.engine import xla_affine
from anyseq_tpu.engine.hirschberg import _merge_halves_affine
from anyseq_tpu_torch.core.types import AffineScoring, Mode
from anyseq_tpu_torch.engine import affine, batch
from anyseq_tpu_torch.kernels import lastcols, walk, wavefront

from conftest import mutate, random_dna

MODES = ["global", "semiglobal", "local"]
# the bench suite's scoring, a steep open, and a free extension (ge = 0)
SCORINGS = [(2, -1, -3, -1), (2, -3, -5, -1), (1, -6, -4, 0)]


def _u8(b: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(b), dtype=torch.uint8)


def _pair(m, n, seed):
    rng = np.random.default_rng(seed)
    q = random_dna(rng, m)
    return q, (mutate(rng, q) + random_dna(rng, n))[:n]


@pytest.mark.parametrize("sc", SCORINGS, ids=str)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,n", [(1, 1), (7, 129), (129, 7), (300, 1100)])
def test_score_rows_affine_matches_xla(m, n, mode, sc):
    q, s = _pair(m, n, m * 31 + n)
    _, _, _, _, qp, sp = jax_api._prep(q, s)
    ref = xla_affine.score_rows_affine(qp, sp, m, n, JaxMode(mode),
                                       JaxAffine(*sc))
    got = wavefront.score(_u8(q), _u8(s), Mode(mode), AffineScoring(*sc))
    assert got.keys() == {"last_row", "last_col", "best"}
    np.testing.assert_array_equal(got["last_row"], np.asarray(
        ref["last_row"])[:n])
    np.testing.assert_array_equal(got["last_col"], np.asarray(
        ref["last_col"])[:m])
    np.testing.assert_array_equal(got["best"], np.asarray(ref["best"]))


@pytest.mark.parametrize("sc", SCORINGS, ids=str)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,n", [(1, 1), (9, 70), (70, 9), (130, 260)])
def test_preds_affine_match_haloed_planes(m, n, mode, sc):
    """The 4-bit codes, unpacked, give the JAX package's haloed PH / PE /
    PF planes (``api._haloed_affine_preds``), and the other outputs agree."""
    q, s = _pair(m, n, m + 7 * n)
    _, _, _, _, qp, sp = jax_api._prep(q, s)
    ref = xla_affine.score_rows_affine_with_preds(qp, sp, m, n, JaxMode(mode),
                                                  JaxAffine(*sc))
    got = wavefront.score(_u8(q), _u8(s), Mode(mode), AffineScoring(*sc),
                          emit_preds=True)
    assert got["preds"].shape == (m, -(-n // 8))
    dense = affine.unpack_codes4(got["preds"], n).numpy()
    want = jax_api._haloed_affine_preds(np.asarray(ref["preds"]), m, n,
                                        JaxMode(mode))
    for a, b in zip(jax_api._haloed_affine_preds(dense, m, n, JaxMode(mode)),
                    want):
        np.testing.assert_array_equal(a, b)
    for k in ("last_row", "last_col", "best"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k])[:got[k].shape[0]])


@pytest.mark.parametrize("sc", SCORINGS, ids=str)
@pytest.mark.parametrize("m,n", [(1, 1), (5, 40), (200, 77)])
def test_start_gap_and_col_e_match_xla(m, n, sc):
    """GLOBAL with the Myers-Miller start-in-gap boundary, and the E last
    column, with and without start_gap."""
    q, s = _pair(m, n, 3 * m + n)
    _, _, _, _, qp, sp = jax_api._prep(q, s)
    for sg in (False, True):
        ref = xla_affine.score_rows_affine(qp, sp, m, n, JaxMode.GLOBAL,
                                           JaxAffine(*sc), start_gap=sg,
                                           emit_col_e=True)
        got = wavefront.score(_u8(q), _u8(s), Mode.GLOBAL, AffineScoring(*sc),
                              start_gap=sg, emit_col_e=True)
        for k in ("last_row", "last_col", "last_col_e", "best"):
            np.testing.assert_array_equal(
                got[k], np.asarray(ref[k])[:got[k].shape[0]], err_msg=k)


def test_start_gap_options_checked():
    q = _u8(b"ACGT")
    with pytest.raises(ValueError, match="GLOBAL"):
        wavefront.score(q, q, Mode.LOCAL, AffineScoring(), start_gap=True)
    with pytest.raises(ValueError, match="GLOBAL"):
        wavefront.score(q, q, Mode.GLOBAL, AffineScoring(), emit_preds=True,
                        start_gap=True)
    from anyseq_tpu_torch.core.types import LinearScoring
    with pytest.raises(ValueError, match="Affine"):
        wavefront.score(q, q, Mode.GLOBAL, LinearScoring(), emit_col_e=True)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 300])
def test_pack_codes4_roundtrip(n):
    rng = np.random.default_rng(n)
    codes = torch.from_numpy(rng.integers(0, 16, (3, n)).astype(np.uint8))
    words = affine.pack_codes4(codes)
    assert words.dtype == torch.int32 and words.shape == (3, -(-n // 8))
    assert torch.equal(affine.unpack_codes4(words, n), codes)


def _batch(seed, B, M, N):
    rng = np.random.default_rng(seed)
    q = rng.integers(65, 69, (B, M)).astype(np.uint8)
    s = rng.integers(65, 69, (B, N)).astype(np.uint8)
    ms = rng.integers(1, M + 1, B).astype(np.int32)
    ns = rng.integers(1, N + 1, B).astype(np.int32)
    ms[0], ns[0] = M, N
    sg = rng.integers(0, 2, B).astype(bool)
    eg = rng.integers(0, 2, B).astype(bool)
    return q, s, ms, ns, sg, eg


def _jax(*arrays):
    return tuple(jnp.asarray(a, jnp.int32) if a.dtype == np.uint8
                 else jnp.asarray(a) for a in arrays)


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("sc", SCORINGS, ids=str)
@pytest.mark.parametrize("B,M,N", [(1, 1, 1), (6, 40, 90), (9, 130, 260)])
def test_last_cols_batch_affine_matches_xla(B, M, N, sc):
    q, s, ms, ns, sg, _ = _batch(B * M + N, B, M, N)
    ref_h, ref_e = (np.asarray(x) for x in jax_batch.last_cols_batch_affine(
        *_jax(q, s, ms, ns), JaxAffine(*sc), jnp.asarray(sg)))
    got_h, got_e = batch.last_cols_batch_affine(*_torch(q, s, ms, ns),
                                                AffineScoring(*sc),
                                                torch.from_numpy(sg))
    # the wrapper's layout: (B, M), zeros past each problem's height
    wrap_h, wrap_e = lastcols.last_cols_affine(*_torch(q, s, ms, ns),
                                               AffineScoring(*sc),
                                               torch.from_numpy(sg))
    for b in range(B):
        h = ms[b]
        np.testing.assert_array_equal(got_h[:h, b], ref_h[:h, b])
        np.testing.assert_array_equal(got_e[:h, b], ref_e[:h, b])
        np.testing.assert_array_equal(wrap_h[b, :h], ref_h[:h, b])
        np.testing.assert_array_equal(wrap_e[b, :h], ref_e[:h, b])
        assert not wrap_h[b, h:].any() and not wrap_e[b, h:].any()


@pytest.mark.parametrize("sc", SCORINGS, ids=str)
def test_preds_walk_batch_affine_matches_xla(sc):
    """The terminal-stripe pred sweep, the 3-state walk from each stripe's
    last cell with mixed start- and end-gap flags, and the stripe
    scores."""
    B, M, N = 10, 50, 70
    q, s, ms, ns, sg, eg = _batch(sum(sc) + 40, B, M, N)
    jsc, tsc = JaxAffine(*sc), AffineScoring(*sc)
    jargs = _jax(q, s, ms, ns) + (jnp.asarray(sg),)
    ref_p, ref_h, ref_e = (np.asarray(x) for x in
                           jax_batch.preds_batch_affine(*jargs[:4], jsc,
                                                        jargs[4]))
    words, cols, cols_e = batch.preds_batch_affine(
        *_torch(q, s, ms, ns), tsc, torch.from_numpy(sg))
    dense = affine.unpack_codes4(words, N).numpy()
    for b in range(B):
        h, w = ms[b], ns[b]
        np.testing.assert_array_equal(dense[b, :h, :w], ref_p[b, :h, :w])
        np.testing.assert_array_equal(cols[:h, b], ref_h[:h, b])
        np.testing.assert_array_equal(cols_e[:h, b], ref_e[:h, b])

    ref_q, ref_s, ref_start = (np.asarray(x) for x in
                               jax_batch.walk_batch_affine(
                                   jnp.asarray(ref_p), *jargs[:4],
                                   jargs[4], jnp.asarray(eg)))
    ends = torch.from_numpy(np.stack([ms, ns], 1) - 1)
    out_q, out_s, start = walk.walk_affine(
        words, *_torch(q, s), ends, Mode.GLOBAL, torch.from_numpy(sg),
        torch.from_numpy(eg))
    np.testing.assert_array_equal(out_q.numpy(), ref_q[:, :M + N])
    np.testing.assert_array_equal(out_s.numpy(), ref_s[:, :M + N])
    np.testing.assert_array_equal(start.numpy(), ref_start)

    ref_q, ref_s, ref_scores = (np.asarray(x) for x in
                                jax_batch.preds_walk_batch_affine(
                                    *jargs[:4], jsc, jargs[4],
                                    jnp.asarray(eg)))
    oq, os_, scores = batch.preds_walk_batch_affine(
        *_torch(q, s, ms, ns), tsc, torch.from_numpy(sg),
        torch.from_numpy(eg))
    np.testing.assert_array_equal(oq.numpy(), ref_q[:, :M + N])
    np.testing.assert_array_equal(os_.numpy(), ref_s[:, :M + N])
    np.testing.assert_array_equal(scores.numpy(), ref_scores)


@pytest.mark.parametrize("mode", MODES)
def test_walk_affine_full_traceback_halo(mode):
    """A single-problem walk from the extracted end cell with the
    full-traceback halo of ``api._haloed_affine_preds``: the port's full
    traceback equals the JAX package's host walk."""
    import anyseq_tpu
    from anyseq_tpu_torch.engine import device_tb

    q, s = _pair(150, 170, 5)
    sc = (2, -3, -5, -1)
    score, _, out_q, out_s, start = device_tb.fulltb(
        _u8(q), _u8(s), Mode(mode), AffineScoring(*sc))
    ref = anyseq_tpu.align_full_tb(q, s, mode, JaxAffine(*sc))
    assert (score, bytes(out_q), bytes(out_s), start) == \
        (ref.score, ref.query_aligned, ref.subject_aligned, ref.start)


@pytest.mark.parametrize("seed", range(6))
def test_mm_merge_matches_merge_halves_affine(seed):
    """Small value ranges make ties common (the smallest k wins, type 1
    wins equal bests); the E columns are raised on some parts so that
    type 2 wins there."""
    rng = np.random.default_rng(seed)
    P, Mb = 9, 30
    hs = rng.integers(2, Mb + 1, P)
    hs[0] = Mb
    mids = rng.integers(1, 40, P)
    rights = rng.integers(1, 40, P)
    HL, HR = (rng.integers(-4, 3, (P, Mb)).astype(np.int32) for _ in "LR")
    EL, ER = (rng.integers(-6, 1, (P, Mb)).astype(np.int32) for _ in "LR")
    EL[::3] += 6
    sg = rng.integers(0, 2, P).astype(bool)
    eg = rng.integers(0, 2, P).astype(bool)
    sc = (2, -1, -3, -1) if seed % 2 else (1, -6, -4, 0)
    k, cross, score = lastcols.mm_merge(
        *_torch(HL, EL, HR, ER, hs, mids, rights), AffineScoring(*sc),
        *_torch(sg, eg))
    wins = 0
    for p in range(P):
        h = int(hs[p])
        want = _merge_halves_affine(
            HL[p, :h].astype(np.int64), EL[p, :h].astype(np.int64),
            HR[p, :h].astype(np.int64), ER[p, :h].astype(np.int64), h,
            int(mids[p]), int(rights[p]), JaxAffine(*sc), bool(sg[p]),
            bool(eg[p]))
        assert (int(k[p]), bool(cross[p]), int(score[p])) == want
        wins += want[1]
    assert 0 < wins < P


def test_matches_pallas_kernel_affine():
    """The JAX package's Pallas kernel (interpret mode) on the affine
    Myers-Miller half-sweep contract: GLOBAL, start_gap, H and E last
    columns."""
    from anyseq_tpu.kernels import band

    rng = np.random.default_rng(12)
    q = random_dna(rng, 200)
    s = (mutate(rng, q) * 8)[:1300]
    m, n = len(q), len(s)
    sc = (2, -1, -3, -1)
    _, _, _, _, qp, sp = jax_api._prep(q, s)
    ref = band.score_pair(qp, sp, m, n, JaxMode.GLOBAL, JaxAffine(*sc),
                          start_gap=True, emit_col=True, interpret=True, G=2)
    got = wavefront.score(_u8(q), _u8(s), Mode.GLOBAL, AffineScoring(*sc),
                          start_gap=True, emit_col_e=True)
    np.testing.assert_array_equal(got["last_col"].numpy(),
                                  np.asarray(ref["last_col"])[:m])
    np.testing.assert_array_equal(got["last_col_e"].numpy(),
                                  np.asarray(ref["last_col_e"])[:m])
