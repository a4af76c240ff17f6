"""The port's band of rows from an explicit boundary (plain K8, linear and
affine) and the chained sweep above ``band.M_MAX``, against the numpy
oracles and the JAX package on XLA:CPU. int32 DP, so every output must be
equal -- no tolerance."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import anyseq_tpu
from anyseq_tpu.core.types import AffineScoring as JaxAffine
from anyseq_tpu.core.types import LinearScoring as JaxLinear
from anyseq_tpu.core.types import Mode as JaxMode
from anyseq_tpu.engine import api as jax_api
from anyseq_tpu.engine import resumable as jax_resumable
from anyseq_tpu.engine import xla_affine, xla_linmem
from anyseq_tpu.engine.hirschberg import align_hirschberg
from anyseq_tpu.ref import oracle, oracle_affine
import anyseq_tpu_torch as pt
from anyseq_tpu_torch.core.types import (
    NEG,
    SCORE_MIN,
    AffineScoring,
    LinearScoring,
    Mode,
)
from anyseq_tpu_torch.engine import affine, hirschberg, linmem
from anyseq_tpu_torch.kernels import band

from conftest import mutate, random_dna

MODES = ["global", "semiglobal", "local"]
SC = LinearScoring(2, -1, -1)
JSC = JaxLinear(2, -1, -1)
# the bench suite's affine scoring, and a free extension (ge = 0)
ASCS = [(2, -1, -3, -1), (1, -6, -4, 0)]


def _u8(b: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(b), dtype=torch.uint8)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _pair(m, n, seed):
    rng = np.random.default_rng(seed)
    q = random_dna(rng, m)
    return q, (mutate(rng, q) + random_dna(rng, n))[:n]


def _first_max(H):
    """(score, i, j) of the first maximum of H in row-major order."""
    k = int(np.argmax(H))
    return [int(H.flat[k]), k // H.shape[1], k % H.shape[1]]


@pytest.mark.parametrize("mode", MODES)
def test_band_matches_oracle_rows(mode):
    """Rows [256, 512) from the oracle's row 255, corner and left column
    equal the oracle's later rows and columns (the JAX package's
    tests/test_kernel.py::test_kernel_band_boundary_inputs)."""
    q, s = _pair(512, 640, 7)
    m, n, i0 = len(q), len(s), 256
    H, _ = oracle.dp_full(q, s, JaxMode(mode), JSC)   # haloed (m+1, n+1)
    args = (_u8(q)[i0:], _u8(s), _i32(H[i0, 1:]), int(H[i0, 0]),
            _i32(H[i0 + 1:, 0]), Mode(mode), SC)
    for fn in (linmem.score_band, band.score_band):
        got = fn(*args)
        assert got.keys() == {"last_row", "last_col", "best"}
        assert all(v.dtype == torch.int32 for v in got.values())
        np.testing.assert_array_equal(got["last_row"], H[m, 1:])
        np.testing.assert_array_equal(got["last_col"], H[i0 + 1:, n])
        assert got["best"].tolist() == _first_max(H[i0 + 1:, 1:])


@pytest.mark.parametrize("sc", ASCS, ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_band_affine_matches_oracle_rows(mode, sc):
    """The affine band from the oracle's H and F rows, corner and H column
    (no E run enters from the left) equals its later H and F rows and H
    and E columns."""
    q, s = _pair(400, 330, 8)
    m, n, i0 = len(q), len(s), 256
    H, E, F, _, _, _ = oracle_affine.dp_full_affine(q, s, JaxMode(mode),
                                                    JaxAffine(*sc))
    h = m - i0
    args = (_u8(q)[i0:], _u8(s), _i32(H[i0, 1:]), _i32(F[i0, 1:]),
            int(H[i0, 0]), _i32(H[i0 + 1:, 0]),
            torch.full((h,), NEG, dtype=torch.int32), Mode(mode),
            AffineScoring(*sc))
    q_band, s_t, row, rowf, corner, col, cole, mode_, sc_ = args
    for got in (affine.score_band_affine(*args),
                band.score_band(q_band, s_t, row, corner, col, mode_, sc_,
                                rowf_in=rowf, cole_in=cole)):
        np.testing.assert_array_equal(got["last_row"], H[m, 1:])
        np.testing.assert_array_equal(got["last_row_f"], F[m, 1:])
        np.testing.assert_array_equal(got["last_col"], H[i0 + 1:, n])
        np.testing.assert_array_equal(got["last_col_e"], E[i0 + 1:, n])
        assert got["best"].tolist() == _first_max(H[i0 + 1:, 1:])


@pytest.mark.parametrize("mode", MODES)
def test_band_matches_jax_score_band(mode):
    """The linear band against the JAX package's resumable._score_band on
    the same top row (a GLOBAL / SEMIGLOBAL / LOCAL row 199)."""
    q, s = _pair(330, 300, 9)
    n, i0, h = len(s), 200, 130
    ref0 = xla_linmem.score_rows(*jax_api._prep(q[:i0], s)[4:], i0, n,
                                 JaxMode(mode), JSC)
    row_in = np.asarray(ref0["last_row"])[:n]
    row, col, best = jax_resumable._score_band(
        jnp.asarray(np.frombuffer(q[i0:i0 + h], np.uint8).astype(np.int32)),
        jnp.asarray(np.frombuffer(s, np.uint8).astype(np.int32)),
        jnp.asarray(row_in), jnp.int32(i0), jnp.int32(h), jnp.int32(n),
        jnp.asarray(np.array([SCORE_MIN, -1, -1], np.int32)), JaxMode(mode),
        JSC, h)
    corner, col_in = linmem.left_col(Mode(mode), SC, i0, h, "cpu")
    got = band.score_band(_u8(q)[i0:i0 + h], _u8(s), _i32(row_in), corner,
                          col_in, Mode(mode), SC)
    np.testing.assert_array_equal(got["last_row"], np.asarray(row))
    np.testing.assert_array_equal(got["last_col"], np.asarray(col))
    if mode == "local":   # the JAX band keeps a best only in LOCAL
        bs, bi, bj = got["best"].tolist()
        assert [bs, bi + i0, bj] == np.asarray(best).tolist()


def _assert_outs(got, ref, m, n, keys):
    assert set(got) == set(keys)
    for k in keys:
        size = {"last_row": n, "best": 3}.get(k, m)
        np.testing.assert_array_equal(got[k], np.asarray(ref[k])[:size], k)


@pytest.mark.parametrize("band_rows", [128, 256])
@pytest.mark.parametrize("mode", MODES)
def test_chained_matches_xla(mode, band_rows):
    """Chained bands equal the single-sweep XLA engine (the JAX package's
    tests/test_kernel.py::test_kernel_chained_bands_linear)."""
    q, s = _pair(700, 500, 11)
    m, n = len(q), len(s)
    ref = xla_linmem.score_rows(*jax_api._prep(q, s)[4:], m, n,
                                JaxMode(mode), JSC)
    got = band.score_pair_chained(_u8(q), _u8(s), Mode(mode), SC,
                                  band_rows=band_rows)
    _assert_outs(got, ref, m, n, ("last_row", "last_col", "best"))
    assert linmem.extract_score_from_outputs(got, m, n, Mode(mode)) == \
        xla_linmem.extract_score_from_outputs(
            {k: np.asarray(v) for k, v in ref.items()}, m, n, JaxMode(mode),
            JSC)


@pytest.mark.parametrize("band_rows", [128, 256])
@pytest.mark.parametrize("mode,start_gap", [(m, False) for m in MODES]
                         + [("global", True)])
def test_chained_affine_matches_xla(mode, start_gap, band_rows):
    """Affine chains carry the H and F rows across bands (and the
    Myers-Miller start_gap boundary in GLOBAL)."""
    q, s = _pair(600, 450, 12)
    m, n = len(q), len(s)
    sc = ASCS[0]
    ref = xla_affine.score_rows_affine(*jax_api._prep(q, s)[4:], m, n,
                                       JaxMode(mode), JaxAffine(*sc),
                                       start_gap=start_gap, emit_col_e=True)
    got = band.score_pair_chained(_u8(q), _u8(s), Mode(mode),
                                  AffineScoring(*sc), band_rows=band_rows,
                                  start_gap=start_gap)
    _assert_outs(got, ref, m, n,
                 ("last_row", "last_col", "last_col_e", "best"))


@pytest.mark.parametrize("sc", [SC, AffineScoring(*ASCS[0])], ids=str)
def test_local_tie_across_bands_takes_earlier(sc):
    """Equal LOCAL maxima in two bands: the earlier band's cell wins, as in
    one sweep and in the JAX chain's strictly-greater merge."""
    rng = np.random.default_rng(13)
    unit = random_dna(rng, 100)
    q = unit + b"T" * 28 + unit         # the copies lie in bands 0 and 1
    s = unit
    m, n = len(q), len(s)
    first = linmem.score_band(_u8(q)[:128], _u8(s), *(
        [linmem.top_row(Mode.LOCAL, SC, n, "cpu"),
         *linmem.left_col(Mode.LOCAL, SC, 0, 128, "cpu")]), Mode.LOCAL, SC)
    second = linmem.score_band(_u8(q)[128:], _u8(s), first["last_row"],
                               *linmem.left_col(Mode.LOCAL, SC, 128, 100,
                                                "cpu"), Mode.LOCAL, SC)
    assert first["best"][0] == second["best"][0] == 2 * n   # a real tie
    got = band.score_pair_chained(_u8(q), _u8(s), Mode.LOCAL, sc,
                                  band_rows=128)
    if isinstance(sc, AffineScoring):
        ref = xla_affine.score_rows_affine(*jax_api._prep(q, s)[4:], m, n,
                                           JaxMode.LOCAL, JaxAffine(*ASCS[0]))
    else:
        ref = xla_linmem.score_rows(*jax_api._prep(q, s)[4:], m, n,
                                    JaxMode.LOCAL, JSC)
    assert got["best"].tolist() == np.asarray(ref["best"]).tolist() == \
        [2 * n, n - 1, n - 1]


@pytest.mark.parametrize("scheme", ["linear", "affine"])
@pytest.mark.parametrize("mode", MODES)
def test_tall_paths_match_reference(monkeypatch, mode, scheme):
    """With M_MAX cut to 150 rows (bands of 128), ``align_score`` runs the
    chain and ``align`` runs its endpoint passes through the chain and
    its levels per half whenever the tallest half passes M_MAX (at four
    parts too): both equal the JAX package on XLA:CPU."""
    monkeypatch.setattr(band, "M_MAX", 150)
    monkeypatch.setattr(band, "M_BAND", 128)
    calls = {"chained": 0, "per_half_parts": 0}
    chained, per_half = band.score_pair_chained, hirschberg._level_per_half

    def count_chained(*args, **kwargs):
        calls["chained"] += 1
        return chained(*args, **kwargs)

    def count_per_half(q, s, parts, sc, mesh=None):
        calls["per_half_parts"] = max(calls["per_half_parts"], len(parts))
        return per_half(q, s, parts, sc, mesh)

    monkeypatch.setattr(band, "score_pair_chained", count_chained)
    monkeypatch.setattr(hirschberg, "_level_per_half", count_per_half)
    q, s = _pair(1100, 1100, 14)
    if scheme == "linear":
        sc, jsc = SC, JSC
    else:
        sc, jsc = AffineScoring(*ASCS[0]), JaxAffine(*ASCS[0])
    assert pt.align_score(q, s, mode, sc, device="cpu") == \
        anyseq_tpu.align_score(q, s, mode, jsc)
    assert calls["chained"] == 1
    got = pt.align(q, s, mode, sc, traceback="hirschberg", device="cpu")
    want = align_hirschberg(q, s, mode, jsc, min_width=256)
    assert (got.score, got.query_aligned, got.subject_aligned, got.start) \
        == (want.score, want.query_aligned, want.subject_aligned, want.start)
    assert calls["chained"] > 1 and calls["per_half_parts"] == 4
