"""anyseq_tpu_torch: imports without JAX, type parity with anyseq_tpu, the
device rule, and what the port refuses."""
import dataclasses
import io
import subprocess
import sys

import numpy as np
import pytest
import torch

import anyseq_tpu
import anyseq_tpu_torch as pt
from anyseq_tpu.io.alignment import print_alignment as jax_print_alignment
from anyseq_tpu_torch.dist.mesh import make_mesh
from anyseq_tpu_torch.engine import hirschberg
from anyseq_tpu_torch.io.alignment import print_alignment
from anyseq_tpu_torch.kernels import (
    _build,
    band,
    lastcols,
    swarm,
    walk,
    wavefront,
)

from conftest import mutate, random_dna

MODULES = [
    "anyseq_tpu_torch",
    "anyseq_tpu_torch.cli",
    "anyseq_tpu_torch.dist.batch",
    "anyseq_tpu_torch.dist.collective",
    "anyseq_tpu_torch.dist.dryrun",
    "anyseq_tpu_torch.dist.mesh",
    "anyseq_tpu_torch.dist.sharded",
    "anyseq_tpu_torch.engine.affine",
    "anyseq_tpu_torch.engine.api",
    "anyseq_tpu_torch.engine.batch",
    "anyseq_tpu_torch.engine.device_tb",
    "anyseq_tpu_torch.engine.hirschberg",
    "anyseq_tpu_torch.engine.linmem",
    "anyseq_tpu_torch.engine.resumable",
    "anyseq_tpu_torch.io.alignment",
    "anyseq_tpu_torch.io.fasta",
    "anyseq_tpu_torch.kernels._build",
    "anyseq_tpu_torch.kernels._sweep",
    "anyseq_tpu_torch.kernels.band",
    "anyseq_tpu_torch.kernels.lastcols",
    "anyseq_tpu_torch.kernels.swarm",
    "anyseq_tpu_torch.kernels.walk",
    "anyseq_tpu_torch.kernels.wavefront",
    "anyseq_tpu_torch.parity",
]


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in MODULES)
        + "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'anyseq_tpu' or k.startswith('anyseq_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True)


@pytest.mark.parametrize("value", ["global", "SemiGlobal", "LOCAL",
                                   anyseq_tpu.Mode.LOCAL])
def test_mode_parse(value):
    if isinstance(value, anyseq_tpu.Mode):
        value = value.value
    assert pt.Mode.parse(value).value == anyseq_tpu.Mode.parse(value).value


def test_probes_raise_value_error():
    with pytest.raises(ValueError):
        pt.align_score(b"", b"ACGT", device="cpu")
    with pytest.raises(ValueError):
        pt.align(b"ACGT", b"", device="cpu")
    with pytest.raises(ValueError):
        pt.align_score(b"ACGT", b"ACGT", "diagonal", device="cpu")
    with pytest.raises(ValueError):
        pt.LinearScoring(2, -1, 1)
    with pytest.raises(ValueError):
        pt.align(b"ACGT", b"ACGT", traceback="sideways", device="cpu")


def test_scoring_from_reference():
    ref = anyseq_tpu.LinearScoring(3, -2, -4)
    assert pt.scoring_from_reference(ref) == pt.LinearScoring(3, -2, -4)
    ref = anyseq_tpu.AffineScoring(3, -2, -5, -1)
    assert pt.scoring_from_reference(ref) == pt.AffineScoring(3, -2, -5, -1)
    with pytest.raises(TypeError, match="AffineScoring"):
        pt.align_score(b"ACGT", b"ACGT", scoring=ref, device="cpu")
    with pytest.raises(ValueError):
        pt.AffineScoring(2, -1, 1, -1)


def test_unported_options_raise(tmp_path):
    """mesh= and mesh= with checkpoint_path= run (they raised before the
    multi-device path was ported); a mesh of another type is refused."""
    mesh = make_mesh(devices=["cpu"] * 2)
    q, s = b"GATTACA" * 9, b"GATTTACA" * 40
    want = pt.align(q, s, "local", device="cpu")
    assert dataclasses.astuple(pt.align(q, s, "local", mesh=mesh)) == \
        dataclasses.astuple(want)
    got = hirschberg.align_hirschberg(q, s, "local", device="cpu", mesh=mesh,
                                      checkpoint_path=str(tmp_path / "ck"))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    with pytest.raises(TypeError, match="Mesh"):
        pt.align(b"ACGT", b"ACGT", mesh=object(), device="cpu")


def test_inputs_str_bytes_array_agree():
    q, s = "GATTACA", "GATTTACA"
    want = pt.align_score(q, s, "local", device="cpu")
    assert pt.align_score(q.encode(), s.encode(), "local", device="cpu") == want
    assert pt.align_score(np.frombuffer(q.encode(), np.uint8),
                          bytearray(s.encode()), "local", device="cpu") == want


def test_cpu_runs_launch_no_kernel(rng):
    """On CPU tensors every wrapper takes its plain version."""
    for k in _build.launches:
        _build.launches[k] = 0
    q = random_dna(rng, 700)
    s = mutate(rng, q)
    for sc in (pt.LinearScoring(), pt.AffineScoring()):
        for mode in ("global", "semiglobal", "local"):
            pt.align_score(q, s, mode, sc, device="cpu")
            pt.align(q, s, mode, sc, traceback="hirschberg", device="cpu")
            pt.align_full_tb(q[:100], s[:120], mode, sc, device="cpu")
            # the collective sweep (K10) and K7's codes, linear and affine
            pt.align(q, s, mode, sc, mesh=make_mesh(devices=["cpu"] * 2))
            t = torch.from_numpy(np.frombuffer(q, np.uint8).copy())
            lens = torch.tensor([len(q)])
            swarm.score_pairs_swarm(t[None], t[None], lens, lens, mode, sc,
                                    emit_preds=True)
    assert set(_build.launches.values()) == {0}


def test_wrappers_refuse_other_devices():
    q = torch.zeros(4, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="device"):
        wavefront.score(q, q, pt.Mode.GLOBAL, pt.LinearScoring())
    words = torch.zeros((1, 4, 1), dtype=torch.int32, device="meta")
    ends = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        walk.walk(words, q[None], q[None], ends, pt.Mode.GLOBAL)
    with pytest.raises(ValueError, match="device"):
        wavefront.score(q, q, pt.Mode.GLOBAL, pt.AffineScoring())
    with pytest.raises(ValueError, match="device"):
        walk.walk_affine(words, q[None], q[None], ends, pt.Mode.GLOBAL)
    ms = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        lastcols.last_cols(q[None], q[None], ms, ms, pt.LinearScoring())
    with pytest.raises(ValueError, match="device"):
        lastcols.last_cols_affine(q[None], q[None], ms, ms,
                                  pt.AffineScoring(), ms.bool())
    for sc in (pt.LinearScoring(), pt.AffineScoring()):
        with pytest.raises(ValueError, match="device"):
            swarm.score_pairs_swarm(q[None], q[None], ms, ms, pt.Mode.LOCAL,
                                    sc)
    row = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        band.score_band(q, q, row, 0, row, pt.Mode.GLOBAL, pt.LinearScoring())
    with pytest.raises(ValueError, match="device"):
        band.score_band(q, q, row, 0, row, pt.Mode.GLOBAL, pt.AffineScoring(),
                        row, row)
    with pytest.raises(ValueError, match="device"):
        band.score_band_collective(q, q, row, 0, row, pt.Mode.GLOBAL,
                                   pt.LinearScoring(), None, None, 0, 0)
    with pytest.raises(ValueError, match="device"):
        band.score_band_collective(q, q, row, 0, row, pt.Mode.GLOBAL,
                                   pt.AffineScoring(), None, None, 0, 0,
                                   rowf_in=row, cole_in=row)


def test_every_kernel_has_a_launch_count():
    """One counter per kernel entry of the library, so that a path that
    bypasses a kernel shows as a count of 0."""
    assert set(_build.launches) == {
        "wavefront_score", "wavefront_preds", "walk", "lastcols",
        "wavefront_affine_score", "wavefront_affine_preds",
        "lastcols_affine", "walk_affine", "swarm_score", "swarm_preds",
        "band", "band_affine", "band_collective", "band_collective_affine"}
    # one launching entry a source and K1's / K2's and K5's / K5p's on the
    # warp strip cores, the peer-access switch of the collective, the grid
    # queries of K8/K10 and of their affine modes, the affine strip width,
    # the width and grid queries of K1 / K2, K5 / K5p, K4 and K5L, and K7's
    # plan (which launch nothing)
    assert len(_build.SIGNATURES) == len(_build.SOURCES) + 15 == 22
    assert {"anyseq_band_grid", "anyseq_band_affine_grid",
            "anyseq_band_affine_strip", "anyseq_sweep", "anyseq_sweep_affine",
            "anyseq_sweep_width", "anyseq_sweep_affine_width",
            "anyseq_sweep_grid", "anyseq_sweep_affine_grid",
            "anyseq_lastcols_width", "anyseq_lastcols_affine_width",
            "anyseq_lastcols_grid", "anyseq_lastcols_affine_grid",
            "anyseq_swarm_plan"} <= set(
                _build.SIGNATURES)


def test_wrappers_check_types():
    q = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        wavefront.score(q, q, pt.Mode.GLOBAL, pt.LinearScoring())


def test_alignment_compact_and_print_match_reference(rng):
    q = random_dna(rng, 150)
    s = mutate(rng, q)
    a = anyseq_tpu.align(q, s, "local")
    b = pt.align(q, s, "local", device="cpu")
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert a.compact() == b.compact()
    out_a, out_b = io.StringIO(), io.StringIO()
    jax_print_alignment(a, max_width=60, file=out_a)
    print_alignment(b, max_width=60, file=out_b)
    assert out_a.getvalue() == out_b.getvalue()
