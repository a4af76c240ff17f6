"""The port's single-pair sweep (plain version of K1/K2) against the JAX
package's XLA row-scan engine and its Pallas kernel: int32 DP, so every
output must be equal -- no tolerance."""
import numpy as np
import pytest
import torch

from anyseq_tpu.core.types import LinearScoring as JaxLinear
from anyseq_tpu.core.types import Mode as JaxMode
from anyseq_tpu.engine import api as jax_api
from anyseq_tpu.engine import xla_linmem
from anyseq_tpu_torch.core.types import LinearScoring, Mode
from anyseq_tpu_torch.engine import linmem
from anyseq_tpu_torch.kernels import wavefront

from conftest import mutate, random_dna

MODES = ["global", "semiglobal", "local"]
SC = LinearScoring(2, -1, -1)
JSC = JaxLinear(2, -1, -1)


def _both(q: bytes, s: bytes, mode: str, preds: bool):
    m, n = len(q), len(s)
    _, _, _, _, qp, sp = jax_api._prep(q, s)
    fn = xla_linmem.score_rows_with_preds if preds else xla_linmem.score_rows
    ref = {k: np.asarray(v) for k, v in
           fn(qp, sp, m, n, JaxMode(mode), JSC).items()}
    qt = torch.frombuffer(bytearray(q), dtype=torch.uint8)
    st = torch.frombuffer(bytearray(s), dtype=torch.uint8)
    got = wavefront.score(qt, st, Mode(mode), SC, emit_preds=preds)
    return ref, {k: v.numpy() for k, v in got.items()}, m, n


def _assert_same(ref, got, m, n, preds):
    np.testing.assert_array_equal(got["last_row"], ref["last_row"][:n])
    np.testing.assert_array_equal(got["last_col"], ref["last_col"][:m])
    np.testing.assert_array_equal(got["best"], ref["best"])
    if preds:
        dense = linmem.unpack_codes(torch.from_numpy(got["preds"]), n)
        np.testing.assert_array_equal(dense.numpy(), ref["preds"][:m, :n])


@pytest.mark.parametrize("preds", [False, True], ids=["score", "preds"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,n", [(1, 1), (7, 129), (129, 7), (300, 1100),
                                 (1100, 300)])
def test_score_rows_matches_xla(m, n, mode, preds):
    rng = np.random.default_rng(m * 7919 + n)
    q = random_dna(rng, m)
    s = (mutate(rng, q) + random_dna(rng, n))[:n]
    ref, got, m, n = _both(q, s, mode, preds)
    _assert_same(ref, got, m, n, preds)


@pytest.mark.parametrize("preds", [False, True], ids=["score", "preds"])
@pytest.mark.parametrize("case", ["self", "all_mismatch", "boundary_best"])
@pytest.mark.parametrize("mode", MODES)
def test_tie_cases(case, mode, preds):
    """Self-alignment (a diagonal of equal maxima), an all-mismatch pair
    (every local cell clamps to 0), and a semiglobal pair whose best is a
    boundary cell."""
    rng = np.random.default_rng(5)
    if case == "self":
        q = s = random_dna(rng, 300)
    elif case == "all_mismatch":
        q, s = b"A" * 60, b"C" * 140
    else:
        q, s = b"ACGT" * 10, b"TTTT" * 30
    ref, got, m, n = _both(q, s, mode, preds)
    _assert_same(ref, got, m, n, preds)
    score, end = xla_linmem.extract_score_from_outputs(
        ref, m, n, JaxMode(mode), JSC)
    got_t = {k: torch.from_numpy(v) for k, v in got.items()}
    assert linmem.extract_score_from_outputs(got_t, m, n, Mode(mode)) == \
        (score, end)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1100])
def test_pack_roundtrip(n):
    rng = np.random.default_rng(n)
    codes = torch.from_numpy(rng.integers(0, 4, (3, n)).astype(np.uint8))
    words = linmem.pack_codes(codes)
    assert words.dtype == torch.int32 and words.shape == (3, -(-n // 16))
    assert torch.equal(linmem.unpack_codes(words, n), codes)


def test_matches_pallas_kernel():
    """The JAX package's Pallas kernel (interpret mode) on the same pair:
    the contract K1 carries over."""
    from anyseq_tpu.kernels import band

    rng = np.random.default_rng(11)
    q = random_dna(rng, 300)
    s = (mutate(rng, q) * 8)[:2400]
    m, n = len(q), len(s)
    _, _, _, _, qp, sp = jax_api._prep(q, s)
    ref = band.score_pair(qp, sp, m, n, JaxMode.SEMIGLOBAL, JSC,
                          interpret=True, G=2)
    got = wavefront.score(torch.frombuffer(bytearray(q), dtype=torch.uint8),
                          torch.frombuffer(bytearray(s), dtype=torch.uint8),
                          Mode.SEMIGLOBAL, SC)
    np.testing.assert_array_equal(got["last_row"].numpy(),
                                  np.asarray(ref["last_row"])[:n])
    np.testing.assert_array_equal(got["last_col"].numpy(),
                                  np.asarray(ref["last_col"])[:m])
