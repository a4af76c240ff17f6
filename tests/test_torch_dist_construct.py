"""The port's distributed construction and data-parallel batches
(``anyseq_tpu_torch.dist``, ``align(mesh=)``, ``align_batch(mesh=)``) on
meshes of CPU devices -- the plain versions, device after device --
against the JAX package on its 8 virtual CPU devices (tests/conftest.py),
as ``tests/test_dist_construct.py`` holds the JAX package's to its single
device: scores, start cells and both strings bit-identical, on an 8-device
ring and a 2 x 4 (dp x sp) mesh; the dp level and pred sweeps; the batch
calls; checkpoints with a mesh; and the dry run."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import anyseq_tpu
import anyseq_tpu_torch as pt
from anyseq_tpu.core import types as jt
from anyseq_tpu.dist import batch as jax_dist_batch
from anyseq_tpu.engine import hirschberg as jax_hb
from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
from anyseq_tpu_torch.dist import batch as dist_batch
from anyseq_tpu_torch.dist.dryrun import dryrun_multichip
from anyseq_tpu_torch.dist.mesh import make_mesh
from anyseq_tpu_torch.engine import affine, hirschberg, linmem

from conftest import mutate, random_dna

SCHEMES = {"linear": (LinearScoring(2, -1, -1), jt.LinearScoring(2, -1, -1)),
           "affine": (AffineScoring(2, -1, -3, -1),
                      jt.AffineScoring(2, -1, -3, -1))}
MESHES = {"mesh8": ((1, 8), None), "mesh2x4": ((2, 4), None)}


def _meshes(name):
    dp, sp = MESHES[name][0]
    return (make_mesh(dp=dp, sp=sp, devices=["cpu"] * 8),
            JaxMesh(np.array(jax.devices()[:8]).reshape(dp, sp),
                    ("dp", "sp")))


def _t(aln):
    return dataclasses.astuple(aln)


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
def test_align_hirschberg_mesh8(mode, scheme):
    """sp_min_width=256: the first two levels run each half over the
    whole ring (the collective sweep), the 4-part level and the terminal
    stripes run data-parallel; equal to the JAX package's distributed
    construction and to the port's single-device one."""
    sc, jsc = SCHEMES[scheme]
    rng = np.random.default_rng(11)
    q = random_dna(rng, 200)
    s = mutate(rng, random_dna(rng, 1500))
    port_mesh, jax_mesh = _meshes("mesh8")
    got = hirschberg.align_hirschberg(q, s, mode, sc, mesh=port_mesh,
                                      sp_min_width=256)
    want = jax_hb.align_hirschberg(q, s, jt.Mode(mode.value), jsc,
                                   mesh=jax_mesh, sp_min_width=256)
    assert _t(got) == _t(want)
    assert _t(got) == _t(hirschberg.align_hirschberg(q, s, mode, sc,
                                                     device="cpu"))


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
def test_align_mesh2x4(mode, scheme):
    """align(mesh=) on a 2 x 4 mesh, the default sp_min_width (every
    level data-parallel at this size): the endpoint passes run over the
    whole mesh flattened into one ring."""
    sc, jsc = SCHEMES[scheme]
    rng = np.random.default_rng(12)
    q = random_dna(rng, 300)
    s = mutate(rng, q)
    port_mesh, jax_mesh = _meshes("mesh2x4")
    got = pt.align(q, s, mode.value, sc, mesh=port_mesh)
    want = anyseq_tpu.align(q, s, mode.value, jsc, mesh=jax_mesh)
    assert _t(got) == _t(want)


def _batch(rng, B, M, N):
    q = rng.integers(65, 69, (B, M)).astype(np.uint8)
    s = rng.integers(65, 69, (B, N)).astype(np.uint8)
    ms = rng.integers(1, M + 1, B).astype(np.int32)
    ns = rng.integers(1, N + 1, B).astype(np.int32)
    sg = rng.integers(0, 2, B).astype(bool)
    return q, s, ms, ns, sg


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(q, s, ms, ns, *rest):
    return (jnp.asarray(q.astype(np.int32)), jnp.asarray(s.astype(np.int32)),
            jnp.asarray(ms), jnp.asarray(ns), *map(jnp.asarray, rest))


def test_level_sweeps_sharded(rng):
    """The dp level sweeps (K4 / K5L on each device) of 19 halves over 8
    devices, against the JAX package's dp-sharded sweeps: each half's
    last column (H and E) over its own rows."""
    q, s, ms, ns, sg = _batch(rng, 19, 40, 70)
    port_mesh, jax_mesh = _meshes("mesh8")
    sc, jsc = SCHEMES["linear"]
    got = dist_batch.last_cols_batch_sharded(*_torch(q, s, ms, ns), sc,
                                             port_mesh)
    want = np.asarray(jax_dist_batch.last_cols_batch_sharded(
        *_jax(q, s, ms, ns), jsc, jax_mesh)).T
    asc, jasc = SCHEMES["affine"]
    got_a = dist_batch.last_cols_batch_affine_sharded(
        *_torch(q, s, ms, ns), asc, torch.from_numpy(sg), port_mesh)
    want_a = [np.asarray(x).T for x in
              jax_dist_batch.last_cols_batch_affine_sharded(
                  *_jax(q, s, ms, ns), jasc, jnp.asarray(sg), jax_mesh)]
    for b in range(19):
        m = ms[b]
        np.testing.assert_array_equal(got[b, :m].numpy(), want[b, :m])
        for g, w in zip(got_a, want_a, strict=True):
            np.testing.assert_array_equal(g[b, :m].numpy(), w[b, :m])


def test_pred_sweeps_sharded(rng):
    """The terminal-stripe pred sweeps, linear and affine, and K7 with
    codes in every mode, over 8 devices against the JAX package's: the
    codes of each problem's cells and its boundary columns."""
    q, s, ms, ns, sg = _batch(rng, 11, 30, 50)
    port_mesh, jax_mesh = _meshes("mesh8")
    sc, jsc = SCHEMES["linear"]
    asc, jasc = SCHEMES["affine"]
    words, cols = dist_batch.preds_batch_sharded(*_torch(q, s, ms, ns), sc,
                                                 port_mesh)
    wpreds, wcols = map(np.asarray, jax_dist_batch.preds_batch_sharded(
        *_jax(q, s, ms, ns), jsc, jax_mesh))
    awords, acols, acols_e = dist_batch.preds_batch_affine_sharded(
        *_torch(q, s, ms, ns), asc, torch.from_numpy(sg), port_mesh)
    wa = [np.asarray(x) for x in jax_dist_batch.preds_batch_affine_sharded(
        *_jax(q, s, ms, ns), jasc, jnp.asarray(sg), jax_mesh)]
    codes = linmem.unpack_codes(words, 50).numpy()
    acodes = affine.unpack_codes4(awords, 50).numpy()
    for b in range(11):
        m, n = ms[b], ns[b]
        np.testing.assert_array_equal(codes[b, :m, :n], wpreds[b, :m, :n])
        np.testing.assert_array_equal(cols[:m, b].numpy(), wcols[:m, b])
        np.testing.assert_array_equal(acodes[b, :m, :n], wa[0][b, :m, :n])
        np.testing.assert_array_equal(acols[:m, b].numpy(), wa[1][:m, b])
        np.testing.assert_array_equal(acols_e[:m, b].numpy(), wa[2][:m, b])
    for mode in Mode:
        got = dist_batch.preds_batch_full_sharded(*_torch(q, s, ms, ns),
                                                  mode, sc, port_mesh)
        wp, wr, wc, wb = map(np.asarray,
                             jax_dist_batch.preds_batch_full_sharded(
                                 *_jax(q, s, ms, ns), jt.Mode(mode.value),
                                 jsc, jax_mesh))
        codes = linmem.unpack_codes(got["preds"], 50).numpy()
        for b in range(11):
            m, n = ms[b], ns[b]
            np.testing.assert_array_equal(codes[b, :m, :n], wp[b, :m, :n])
            np.testing.assert_array_equal(got["last_rows"][b, :n].numpy(),
                                          wr[b, :n])
            np.testing.assert_array_equal(got["last_cols"][b, :m].numpy(),
                                          wc[b, :m])
            if mode is Mode.LOCAL:
                assert got["best"][b].tolist() == wb[b].tolist()


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batches_over_a_mesh(mesh_name):
    """align_scores_batch_sharded and align_batch(mesh=) in 3 modes,
    linear, and affine alignments (pair by pair on the first device), over
    an odd batch of two shape buckets, against the JAX package's."""
    rng = np.random.default_rng(13)
    qs = [random_dna(rng, int(rng.integers(20, 300))) for _ in range(17)]
    ss = [mutate(rng, x) for x in qs]
    port_mesh, jax_mesh = _meshes(mesh_name)
    for mode in ("global", "semiglobal", "local"):
        for scheme in SCHEMES:
            sc, jsc = SCHEMES[scheme]
            got = dist_batch.align_scores_batch_sharded(qs, ss, mode, sc,
                                                        port_mesh)
            want = jax_dist_batch.align_scores_batch_sharded(qs, ss, mode,
                                                             jsc, jax_mesh)
            assert got.tolist() == want.tolist(), (mode, scheme)
        sc, jsc = SCHEMES["linear"]
        got = pt.align_batch(qs, ss, mode, sc, mesh=port_mesh)
        want = anyseq_tpu.align_batch(qs, ss, mode, jsc, mesh=jax_mesh)
        assert [_t(a) for a in got] == [_t(a) for a in want], mode
    asc, jasc = SCHEMES["affine"]
    got = pt.align_batch(qs[:3], ss[:3], "local", asc, mesh=port_mesh)
    want = anyseq_tpu.align_batch(qs[:3], ss[:3], "local", jasc,
                                  mesh=jax_mesh)
    assert [_t(a) for a in got] == [_t(a) for a in want]


def test_mesh_none_is_single_device():
    rng = np.random.default_rng(14)
    qs = [random_dna(rng, 40) for _ in range(3)]
    ss = [mutate(rng, x) for x in qs]
    got = dist_batch.align_scores_batch_sharded(qs, ss, "local",
                                                device="cpu")
    assert got.tolist() == pt.align_scores_batch(qs, ss, "local",
                                                 device="cpu").tolist()


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_checkpoint_with_mesh(tmp_path, scheme):
    """checkpoint_path with a mesh, as in the JAX package: a run killed
    after its first save resumes (with or without the mesh) to the
    bytes of a clean single-device run."""
    sc, _ = SCHEMES[scheme]
    rng = np.random.default_rng(15)
    q = random_dna(rng, 150)
    s = mutate(rng, random_dna(rng, 1200))
    port_mesh, _ = _meshes("mesh8")
    clean = hirschberg.align_hirschberg(q, s, "semiglobal", sc, device="cpu")
    path = str(tmp_path / "hb.npz")

    class Killed(Exception):
        pass

    save = hirschberg._HbCheckpoint.save

    def save_then_fail(self, **arrays):
        save(self, **arrays)
        raise Killed()

    hirschberg._HbCheckpoint.save = save_then_fail
    try:
        with pytest.raises(Killed):
            hirschberg.align_hirschberg(q, s, "semiglobal", sc,
                                        mesh=port_mesh, sp_min_width=256,
                                        checkpoint_path=path)
    finally:
        hirschberg._HbCheckpoint.save = save
    for mesh in (port_mesh, None):
        again = hirschberg.align_hirschberg(q, s, "semiglobal", sc,
                                            device="cpu", mesh=mesh,
                                            sp_min_width=256,
                                            checkpoint_path=path)
        assert _t(again) == _t(clean)


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multichip(n):
    dryrun_multichip(n, ["cpu"] * n)
