"""The port's traceback walk (plain version of K3) against the JAX
package's batched XLA walk and its Pallas walk kernel."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anyseq_tpu.core.types import LinearScoring as JaxLinear
from anyseq_tpu.core.types import Mode as JaxMode
from anyseq_tpu.engine import api as jax_api
from anyseq_tpu.engine import batch as jax_batch
from anyseq_tpu.ref import oracle
from anyseq_tpu_torch.core.types import LinearScoring, Mode
from anyseq_tpu_torch.engine import device_tb, linmem
from anyseq_tpu_torch.kernels import walk

from conftest import random_dna

SC = LinearScoring(2, -1, -1)
JSC = JaxLinear(2, -1, -1)


def _batch(rng, B, M, N):
    q = rng.integers(65, 69, (B, M)).astype(np.uint8)
    s = rng.integers(65, 69, (B, N)).astype(np.uint8)
    ms = rng.integers(1, M + 1, B).astype(np.int32)
    ns = rng.integers(1, N + 1, B).astype(np.int32)
    return q, s, ms, ns


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
def test_walk_matches_xla_walk(mode):
    """Walks from random end cells, one of them dead (-1, -1), over the
    JAX package's dense codes packed into the port's layout."""
    rng = np.random.default_rng(3)
    B, M, N = 12, 70, 150
    q, s, ms, ns = _batch(rng, B, M, N)
    preds, _ = jax_batch.preds_batch(jnp.asarray(q, jnp.int32),
                                     jnp.asarray(s, jnp.int32),
                                     jnp.asarray(ms), jnp.asarray(ns), JSC)
    preds = np.asarray(preds)
    ends = np.stack([rng.integers(0, ms), rng.integers(0, ns)], 1)
    ends = ends.astype(np.int32)
    ends[4] = (-1, -1)
    ends[5] = (ms[5] - 1, ns[5] - 1)
    ref_q, ref_s, ref_start = (np.asarray(x) for x in jax_batch.walk_batch_ends(
        jnp.asarray(preds), jnp.asarray(q, jnp.int32),
        jnp.asarray(s, jnp.int32), jnp.asarray(ms), jnp.asarray(ns),
        jnp.asarray(ends), JaxMode(mode)))
    words = linmem.pack_codes(torch.from_numpy(preds.copy()))
    out_q, out_s, start = walk.walk(words, torch.from_numpy(q),
                                    torch.from_numpy(s),
                                    torch.from_numpy(ends), Mode(mode))
    np.testing.assert_array_equal(out_q.numpy(), ref_q[:, :M + N])
    np.testing.assert_array_equal(out_s.numpy(), ref_s[:, :M + N])
    np.testing.assert_array_equal(start.numpy(), ref_start)
    assert tuple(start[4].tolist()) == (0, 0)


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
@pytest.mark.parametrize("m,n", [(128, 128), (100, 156), (1, 255)])
def test_fulltb_walk_out_len_multiple_of_256(m, n, mode):
    """(m + n) % 256 == 0: the last live position is m + n - 1, and the
    port writes live steps only, so nothing may be erased there."""
    rng = np.random.default_rng(m + n)
    q = random_dna(rng, m)
    s = random_dna(rng, n)
    qt = torch.frombuffer(bytearray(q), dtype=torch.uint8)
    st = torch.frombuffer(bytearray(s), dtype=torch.uint8)
    score, _, out_q, out_s, start = device_tb.fulltb(qt, st, Mode(mode), SC)
    exp_score, exp_q, exp_s, exp_start = oracle.align(q, s, JaxMode(mode),
                                                      JSC)
    assert score == exp_score
    assert bytes(out_q) == bytes(exp_q)
    assert bytes(out_s) == bytes(exp_s)
    assert start == exp_start


def test_walk_matches_pallas_walk():
    """The JAX package's Pallas walk (interpret mode) over its own packed
    codes gives the same strings and start as the port's walk."""
    from anyseq_tpu.engine import device_tb as jax_device_tb
    from anyseq_tpu.kernels import band

    rng = np.random.default_rng(17)
    q = random_dna(rng, 128)
    s = random_dna(rng, 128)
    m, n = len(q), len(s)
    _, _, _, _, qp, sp = jax_api._prep(q, s)
    outs = band.score_pair(qp, sp, m, n, JaxMode.LOCAL, JSC, interpret=True,
                           G=2, emit_preds=True)
    end = (int(outs["best"][1]), int(outs["best"][2]))
    ref_q, ref_s, ref_start = jax_device_tb.walk_packed(
        outs, qp, sp, m, n, end, JaxMode.LOCAL, interpret=True)
    _, got_end, out_q, out_s, start = device_tb.fulltb(
        torch.frombuffer(bytearray(q), dtype=torch.uint8),
        torch.frombuffer(bytearray(s), dtype=torch.uint8), Mode.LOCAL, SC)
    assert got_end == end
    assert bytes(out_q) == bytes(ref_q)
    assert bytes(out_s) == bytes(ref_s)
    assert start == ref_start
