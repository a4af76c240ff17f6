"""The port's batched level sweep (plain version of K4), its terminal pred
sweep, and the hb_sum merge, against the JAX package."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anyseq_tpu.core.types import LinearScoring as JaxLinear
from anyseq_tpu.engine import batch as jax_batch
from anyseq_tpu.engine.hirschberg import _merge_halves
from anyseq_tpu_torch.core.types import LinearScoring
from anyseq_tpu_torch.engine import batch, linmem
from anyseq_tpu_torch.kernels import lastcols

SC = LinearScoring(2, -1, -1)
JSC = JaxLinear(2, -1, -1)


def _batch(seed, B, M, N):
    rng = np.random.default_rng(seed)
    q = rng.integers(65, 69, (B, M)).astype(np.uint8)
    s = rng.integers(65, 69, (B, N)).astype(np.uint8)
    ms = rng.integers(1, M + 1, B).astype(np.int32)
    ns = rng.integers(1, N + 1, B).astype(np.int32)
    ms[0], ns[0] = M, N
    return q, s, ms, ns


def _jax(q, s, ms, ns):
    return (jnp.asarray(q, jnp.int32), jnp.asarray(s, jnp.int32),
            jnp.asarray(ms), jnp.asarray(ns))


def _torch(q, s, ms, ns):
    return tuple(torch.from_numpy(x) for x in (q, s, ms, ns))


@pytest.mark.parametrize("B,M,N", [(1, 1, 1), (6, 40, 90), (17, 130, 260),
                                   (4, 300, 1100)])
def test_last_cols_batch_matches_xla(B, M, N):
    q, s, ms, ns = _batch(B * M + N, B, M, N)
    ref = np.asarray(jax_batch.last_cols_batch(*_jax(q, s, ms, ns), JSC))
    got = batch.last_cols_batch(*_torch(q, s, ms, ns), SC).numpy()
    for b in range(B):
        np.testing.assert_array_equal(got[: ms[b], b], ref[: ms[b], b])
    # the wrapper's layout: (B, M), zeros past each problem's height
    wrapped = lastcols.last_cols(*_torch(q, s, ms, ns), SC).numpy()
    for b in range(B):
        np.testing.assert_array_equal(wrapped[b, : ms[b]], ref[: ms[b], b])
        assert not wrapped[b, ms[b]:].any()


@pytest.mark.parametrize("B,M,N", [(5, 33, 47), (9, 130, 256)])
def test_preds_batch_matches_xla(B, M, N):
    q, s, ms, ns = _batch(B + M + N, B, M, N)
    ref_p, ref_c = (np.asarray(x) for x in
                    jax_batch.preds_batch(*_jax(q, s, ms, ns), JSC))
    words, cols = batch.preds_batch(*_torch(q, s, ms, ns), SC)
    dense = linmem.unpack_codes(words, N).numpy()
    for b in range(B):
        np.testing.assert_array_equal(dense[b, : ms[b], : ns[b]],
                                      ref_p[b, : ms[b], : ns[b]])
        np.testing.assert_array_equal(cols.numpy()[: ms[b], b],
                                      ref_c[: ms[b], b])


def test_preds_walk_batch_scores():
    q, s, ms, ns = _batch(8, 8, 60, 70)
    ref_q, ref_s = (np.asarray(x) for x in
                    jax_batch.preds_walk_batch(*_jax(q, s, ms, ns), JSC))
    out_q, out_s, scores = batch.preds_walk_batch(*_torch(q, s, ms, ns), SC)
    np.testing.assert_array_equal(out_q.numpy(), ref_q[:, :130])
    np.testing.assert_array_equal(out_s.numpy(), ref_s[:, :130])
    ref_c = np.asarray(jax_batch.last_cols_batch(*_jax(q, s, ms, ns), JSC))
    np.testing.assert_array_equal(scores.numpy(),
                                  ref_c[ms - 1, np.arange(8)])


@pytest.mark.parametrize("seed", range(6))
def test_hb_merge_matches_merge_halves(seed):
    """Small value ranges make ties common: the smallest k must win."""
    rng = np.random.default_rng(seed)
    P, Mb = 7, 40
    hs = rng.integers(1, Mb + 1, P)
    hs[0] = Mb
    mids = rng.integers(1, 50, P)
    rights = rng.integers(1, 50, P)
    L = rng.integers(-3, 3, (P, Mb)).astype(np.int32)
    R = rng.integers(-3, 3, (P, Mb)).astype(np.int32)
    g = -1 if seed % 2 else 0
    k, score = lastcols.hb_merge(torch.from_numpy(L), torch.from_numpy(R),
                                 torch.from_numpy(hs), torch.from_numpy(mids),
                                 torch.from_numpy(rights), g)
    for p in range(P):
        h = int(hs[p])
        want = _merge_halves(L[p, :h].astype(np.int64),
                             R[p, :h].astype(np.int64), h, int(mids[p]),
                             int(rights[p]), g)
        assert (int(k[p]), int(score[p])) == want
