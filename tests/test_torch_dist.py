"""The port's collective sweep (``anyseq_tpu_torch.dist``) on meshes of CPU
devices -- the plain version of K10, rank after rank -- against the JAX
package on its 8 virtual CPU devices (tests/conftest.py), on the same
seeded inputs: the sharded score (the JAX side's ``engine="xla"``, which
its own tests hold bit-identical to its collective engine, and one small
case of the collective engine under the TPU interpreter), chained bands,
ranks without columns, a LOCAL tie across a rank boundary and the 2-D
(dp x sp) batch. Outputs are int32 and must be bit-identical."""
import socket

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from anyseq_tpu.core import types as jt
from anyseq_tpu.dist import collective as jax_collective
from anyseq_tpu.dist.sharded import score_pair_sharded as jax_sharded
from anyseq_tpu.engine import api as jax_api
from anyseq_tpu.engine import xla_affine, xla_linmem
from anyseq_tpu_torch.core.types import (
    AffineScoring,
    LinearScoring,
    Mode,
    as_tensor,
)
from anyseq_tpu_torch.dist import collective, mesh as meshlib, sharded
from anyseq_tpu_torch.dist.mesh import Mesh, make_mesh
from anyseq_tpu_torch.engine import linmem
from anyseq_tpu_torch.kernels import wavefront

SCHEMES = {"linear": (LinearScoring(2, -1, -1), jt.LinearScoring(2, -1, -1)),
           "affine": (AffineScoring(2, -1, -3, -1),
                      jt.AffineScoring(2, -1, -3, -1))}


def _seqs(rng, m, n):
    q = rng.integers(0, 4, m, dtype=np.uint8) + np.uint8(ord("A"))
    s = rng.integers(0, 4, n, dtype=np.uint8) + np.uint8(ord("A"))
    return q, s


def _cpu_ring(k):
    return Mesh(["cpu"] * k, ("sp",))


def _jax_ring(k):
    return JaxMesh(np.array(jax.devices()[:k]), ("sp",))


def _check(got, want, m, n, mode, sc):
    """The port's outputs against the JAX package's: rows and columns
    (cut to the pair), the extracted score and end cell, and the LOCAL
    best."""
    np.testing.assert_array_equal(got["last_row"].numpy()[:n],
                                  np.asarray(want["last_row"])[:n])
    np.testing.assert_array_equal(got["last_col"].numpy()[:m],
                                  np.asarray(want["last_col"])[:m])
    if "last_col_e" in want:
        np.testing.assert_array_equal(got["last_col_e"].numpy()[:m],
                                      np.asarray(want["last_col_e"])[:m])
    jw = {k: np.asarray(v) for k, v in want.items()}
    score, end = linmem.extract_score_from_outputs(got, m, n, mode)
    wscore, wend = xla_linmem.extract_score_from_outputs(
        jw, m, n, jt.Mode(mode.value), sc)
    assert (score, end) == (wscore, tuple(map(int, wend)))
    if mode is Mode.LOCAL:
        assert got["best"].tolist() == jw["best"].tolist()


def _jax_single(q, s, mode, jsc, start_gap=False):
    """The JAX package's single-device row scan of the pair."""
    _, _, m, n, qp, sp = jax_api._prep(bytes(q), bytes(s))
    jmode = jt.Mode(mode.value)
    if isinstance(jsc, jt.AffineScoring):
        return xla_affine.score_rows_affine(qp, sp, m, n, jmode, jsc,
                                            start_gap=start_gap,
                                            emit_col_e=True)
    return xla_linmem.score_rows(qp, sp, m, n, jmode, jsc)


def test_make_mesh():
    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.axis_names == ("dp", "sp")
    assert mesh.shape == {"dp": 1, "sp": 8}
    assert make_mesh(dp=2, devices=["cpu"] * 8).shape == {"dp": 2, "sp": 4}
    assert make_mesh(sp=2, devices=["cpu"] * 8).shape == {"dp": 4, "sp": 2}
    assert mesh.device_list() == [torch.device("cpu")] * 8
    with pytest.raises(ValueError, match="device count"):
        make_mesh(sp=3, dp=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 4, ("dp", "sp"))


def test_init_distributed():
    """Without a coordinator a no-op (one process); with one, the process
    joins a run over torch.distributed (here a run of one), and make_mesh
    gathers the run's devices (tests/test_torch_multihost.py runs two)."""
    meshlib.init_distributed()
    assert not torch.distributed.is_initialized()
    assert (meshlib.process_index(), meshlib.process_count()) == (0, 1)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    meshlib.init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        assert torch.distributed.is_initialized()
        assert (meshlib.process_index(), meshlib.process_count()) == (0, 1)
        mesh = make_mesh(devices=["cpu"] * 2)
        assert mesh.owner_list() == [0, 0] and not mesh.spans_processes
    finally:
        torch.distributed.destroy_process_group()


def test_lex_best_merge_order():
    """Highest score, then smallest i, then smallest j, whatever the
    order of the ranks."""
    bests = torch.tensor([[5, 9, 3], [7, 4, 2000], [7, 4, 1100], [7, 6, 1]],
                         dtype=torch.int32)
    assert meshlib.lex_best_merge(bests).tolist() == [7, 4, 1100]
    assert meshlib.lex_best_merge(bests.flip(0)).tolist() == [7, 4, 1100]


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("k", [2, 4])
def test_collective_matches_jax(rng, k, mode, scheme):
    """2 and 4 ranks (with 4, n = 2,500 leaves the last rank without
    columns) against the JAX package's sharded score on as many
    devices."""
    sc, jsc = SCHEMES[scheme]
    q, s = _seqs(rng, 300, 2500)
    got = collective.score_pair_collective(q, s, mode, sc, _cpu_ring(k))
    want = jax_sharded(q, s, jt.Mode(mode.value), jsc, _jax_ring(k),
                       engine="xla")
    _check(got, want, 300, 2500, mode, jsc)


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
def test_collective_chained_bands(rng, mode, scheme):
    """Bands cut small (band_rows=64, the last band ragged): each band's
    corner comes from the halo of the band before; equal to the JAX
    package's sharded score and to one single-device sweep."""
    sc, jsc = SCHEMES[scheme]
    q, s = _seqs(rng, 300, 2100)
    got = collective.score_pair_collective(q, s, mode, sc, _cpu_ring(2),
                                           band_rows=64)
    want = jax_sharded(q, s, jt.Mode(mode.value), jsc, _jax_ring(2),
                       engine="xla")
    _check(got, want, 300, 2100, mode, jsc)
    kw = {"emit_col_e": True} if scheme == "affine" else {}
    single = wavefront.score(as_tensor(q, "cpu"), as_tensor(s, "cpu"), mode,
                             sc, **kw)
    for key in single:
        assert torch.equal(got[key], single[key]), key


def test_collective_affine_start_gap(rng):
    """The Myers-Miller boundary over 4 ranks with chained bands: the
    corner of rank k > 0's first band is the top row's, its later corners
    the halo's."""
    sc, jsc = SCHEMES["affine"]
    q, s = _seqs(rng, 150, 3500)
    got = collective.score_pair_collective(q, s, Mode.GLOBAL, sc,
                                           _cpu_ring(4), band_rows=50,
                                           start_gap=True)
    want = _jax_single(q, s, Mode.GLOBAL, jsc, start_gap=True)
    _check(got, want, 150, 3500, Mode.GLOBAL, jsc)
    want = jax_sharded(q, s, jt.Mode.GLOBAL, jsc, _jax_ring(4), engine="xla",
                       start_gap=True)
    _check(got, want, 150, 3500, Mode.GLOBAL, jsc)


def test_collective_matches_jax_collective_engine(rng):
    """One small case against the JAX package's collective kernel under
    the TPU interpreter, as tests/test_collective.py runs it."""
    sc, jsc = SCHEMES["linear"]
    q, s = _seqs(rng, 130, 1600)
    got = collective.score_pair_collective(q, s, Mode.GLOBAL, sc,
                                           _cpu_ring(2))
    want = jax_collective.score_pair_collective(q, s, jt.Mode.GLOBAL, jsc,
                                                _jax_ring(2),
                                                interpret="tpu")
    _check(got, want, 130, 1600, Mode.GLOBAL, jsc)


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
def test_empty_ranks(rng, mode, scheme):
    """8 ranks over 1,500 columns: two ranks own them, six are not
    launched; last_col comes from the rank that owns column n - 1."""
    sc, jsc = SCHEMES[scheme]
    q, s = _seqs(rng, 90, 1500)
    assert collective.geometry(90, 1500, 8)[:2] == (1024, 2)
    got = collective.score_pair_collective(q, s, mode, sc, _cpu_ring(8),
                                           band_rows=40)
    assert got["last_row"].shape == (1500,) and got["last_col"].shape == (90,)
    _check(got, _jax_single(q, s, mode, jsc), 90, 1500, mode, jsc)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_local_tie_across_rank_boundary(scheme):
    """Equal LOCAL maxima on both sides of the boundary between ranks 0
    and 1 (column 1024): rank 1's ends in an earlier row and must win,
    and within a row the smaller column wins."""
    sc, jsc = SCHEMES[scheme]
    rng = np.random.default_rng(7)
    a, b, c = (rng.integers(0, 4, 30, dtype=np.uint8) + 65 for _ in range(3))
    q = np.concatenate([a, b, c])
    n_ = np.full(1, ord("N"), np.uint8)
    # rank 0 holds b + c (rows 30..89), rank 1 holds a + b (rows 0..59)
    s = np.concatenate([np.repeat(n_, 600), b, c, np.repeat(n_, 600), a, b,
                        np.repeat(n_, 500)])
    got = collective.score_pair_collective(q, s, Mode.LOCAL, sc,
                                           _cpu_ring(2))
    score, i, j = got["best"].tolist()
    assert (score, i) == (120, 59) and j >= 1024
    _check(got, _jax_single(q, s, Mode.LOCAL, jsc), 90, len(s), Mode.LOCAL,
           jsc)
    # a tie in one row: the smaller column, on rank 0
    s2 = np.concatenate([np.repeat(n_, 600), a, b, np.repeat(n_, 600), a, b,
                         np.repeat(n_, 500)])
    got = collective.score_pair_collective(q, s2, Mode.LOCAL, sc,
                                           _cpu_ring(2))
    assert got["best"].tolist() == [120, 59, 659]
    _check(got, _jax_single(q, s2, Mode.LOCAL, jsc), 90, len(s2), Mode.LOCAL,
           jsc)


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
def test_score_pair_sharded_flattens_meshes(rng, mode, scheme):
    """score_pair_sharded on a 2 x 4 (dp x sp) mesh runs one ring of 8
    ranks; equal to the JAX package's on its 2 x 4 mesh."""
    sc, jsc = SCHEMES[scheme]
    q, s = _seqs(rng, 120, 9000)
    got = sharded.score_pair_sharded(q, s, mode, sc,
                                     make_mesh(dp=2, sp=4,
                                               devices=["cpu"] * 8))
    jmesh = JaxMesh(np.array(jax.devices()).reshape(2, 4), ("dp", "sp"))
    want = jax_sharded(q, s, jt.Mode(mode.value), jsc, jmesh, engine="xla")
    _check(got, want, 120, 9000, mode, jsc)
    with pytest.raises(TypeError, match="Mesh"):
        sharded.score_pair_sharded(q, s, mode, sc, object())


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
def test_score_pairs_collective_2d(rng, mode, scheme):
    """3 pairs on a 2 x 2 (dp x sp) mesh, chained bands: each dp row is
    its own ring; (score, end) equal to the JAX package's per pair."""
    sc, jsc = SCHEMES[scheme]
    pairs = [_seqs(rng, int(rng.integers(100, 300)),
                   int(rng.integers(900, 2600))) for _ in range(3)]
    got = collective.score_pairs_collective(
        [p[0] for p in pairs], [p[1] for p in pairs], mode, sc,
        make_mesh(dp=2, sp=2, devices=["cpu"] * 4), band_rows=64)
    for (q, s), (score, end) in zip(pairs, got):
        want = {k: np.asarray(v) for k, v in
                _jax_single(q, s, mode, jsc).items()}
        wscore, wend = xla_linmem.extract_score_from_outputs(
            want, len(q), len(s), jt.Mode(mode.value), jsc)
        assert (score, end) == (wscore, tuple(map(int, wend)))


def test_collective_bad_inputs(rng):
    q, s = _seqs(rng, 10, 20)
    sc = LinearScoring()
    with pytest.raises(ValueError, match="1-D mesh"):
        collective.score_pair_collective(q, s, Mode.GLOBAL, sc,
                                         make_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="start_gap"):
        collective.score_pair_collective(q, s, Mode.LOCAL,
                                         AffineScoring(), _cpu_ring(2),
                                         start_gap=True)
    with pytest.raises(ValueError, match="empty"):
        collective.score_pair_collective(q[:0], s, Mode.GLOBAL, sc,
                                         _cpu_ring(2))
    with pytest.raises(ValueError, match="2-D mesh"):
        collective.score_pairs_collective([q], [s], Mode.GLOBAL, sc,
                                          _cpu_ring(2))
