"""Checkpoint/resume in the port (the JAX package's tests/test_resumable.py,
ported): the band-wise ``ResumableScorer`` and the checkpointed
``align_hirschberg`` against the JAX package on XLA:CPU, and kill-anywhere
restarts that give identical results."""
import dataclasses

import numpy as np
import pytest

from anyseq_tpu.core.types import AffineScoring as JaxAffine
from anyseq_tpu.core.types import LinearScoring as JaxLinear
from anyseq_tpu.engine.hirschberg import align_hirschberg as jax_hirschberg
from anyseq_tpu.engine.resumable import ResumableScorer as JaxResumable
from anyseq_tpu.ref import oracle
from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
from anyseq_tpu_torch.engine import hirschberg
from anyseq_tpu_torch.engine.resumable import ResumableScorer

from conftest import mutate, random_dna

SC = LinearScoring(2, -1, -1)
JSC = JaxLinear(2, -1, -1)
MODES = ["global", "semiglobal", "local"]


@pytest.mark.parametrize("mode", MODES)
def test_resumable_matches_jax(mode):
    """outputs() and score() equal the JAX ResumableScorer's (its row is
    padded past n) and the oracle's last row and column."""
    rng = np.random.default_rng(61)
    q = random_dna(rng, 500)
    s = mutate(rng, q)
    got = ResumableScorer(q, s, mode, SC, band_rows=128, device="cpu")
    want = JaxResumable(q, s, mode, JSC, band_rows=128)
    outs, ref = got.run(), want.run()
    n = len(s)
    np.testing.assert_array_equal(outs["last_row"], ref["last_row"][:n])
    np.testing.assert_array_equal(outs["last_col"], ref["last_col"])
    np.testing.assert_array_equal(outs["best"], ref["best"])
    assert got.score() == want.score()
    H, _ = oracle.dp_full(q, s, mode, JSC)
    np.testing.assert_array_equal(outs["last_row"], H[len(q), 1:])
    np.testing.assert_array_equal(outs["last_col"], H[1:, n])


def test_resume_midway_identical(tmp_path):
    rng = np.random.default_rng(62)
    q = random_dna(rng, 600)
    s = mutate(rng, q)
    path = str(tmp_path / "ck.npz")

    # run 3 bands then "crash"
    sc1 = ResumableScorer(q, s, "global", SC, band_rows=100,
                          checkpoint_path=path, device="cpu")
    for _ in range(3):
        sc1.step()
    assert sc1.band == 3
    del sc1

    # resume in a fresh object and finish
    sc2 = ResumableScorer.resume(path, q, s, "global", SC, band_rows=100,
                                 device="cpu")
    assert sc2.band == 3
    outs = sc2.run()
    clean = ResumableScorer(q, s, "global", SC, band_rows=100,
                            device="cpu").run()
    for k in clean:
        np.testing.assert_array_equal(outs[k], clean[k])
    want = JaxResumable(q, s, "global", JSC, band_rows=100)
    want.run()
    assert sc2.score() == want.score()
    assert sc2.score()[0] == oracle.align_score(q, s, "global", JSC)


def test_resume_rejects_mismatched_problem(tmp_path):
    rng = np.random.default_rng(63)
    q = random_dna(rng, 300)
    s = random_dna(rng, 300)
    path = str(tmp_path / "ck.npz")
    sc1 = ResumableScorer(q, s, "global", SC, band_rows=64,
                          checkpoint_path=path, device="cpu")
    sc1.step()
    with pytest.raises(ValueError):
        ResumableScorer.resume(path, q, s + b"A", "global", SC, band_rows=64,
                               device="cpu")
    with pytest.raises(ValueError):
        ResumableScorer.resume(path, q, s, "global", SC, band_rows=32,
                               device="cpu")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scheme", ["linear", "affine"])
def test_hirschberg_construction_checkpoint_resume(tmp_path, mode, scheme):
    """Kill the construction after each checkpoint save (divide level,
    terminal chunk, endpoint stage); resuming gives the bytes of a clean
    run and of the JAX package's construction at min_width=256."""
    if scheme == "linear":
        sc, jsc = SC, JSC
    else:
        sc, jsc = AffineScoring(2, -1, -3, -1), JaxAffine(2, -1, -3, -1)
    rng = np.random.default_rng(40)
    q = random_dna(rng, 600)
    s = mutate(rng, q)
    clean = dataclasses.astuple(hirschberg.align_hirschberg(
        q, s, mode, sc, device="cpu"))
    assert clean == dataclasses.astuple(jax_hirschberg(q, s, mode, jsc,
                                                       min_width=256))

    class Killed(Exception):
        pass

    orig_save = hirschberg._HbCheckpoint.save
    k = 0
    while True:
        path = str(tmp_path / f"hb_{k}.npz")
        remaining = [k]

        def save_and_die(self, **arrays):
            orig_save(self, **arrays)
            if remaining[0] == 0:
                raise Killed()
            remaining[0] -= 1

        hirschberg._HbCheckpoint.save = save_and_die
        try:
            aln = hirschberg.align_hirschberg(q, s, mode, sc, device="cpu",
                                              checkpoint_path=path)
            # the run completed before the k-th kill: no saves left
            assert dataclasses.astuple(aln) == clean
            break
        except Killed:
            pass
        finally:
            hirschberg._HbCheckpoint.save = orig_save
        aln = hirschberg.align_hirschberg(q, s, mode, sc, device="cpu",
                                          checkpoint_path=path)
        assert dataclasses.astuple(aln) == clean
        k += 1
    assert k >= 3   # levels, terminal chunks (and endpoint stages)


def test_hirschberg_checkpoint_mismatch_rejected(tmp_path):
    rng = np.random.default_rng(41)
    q = random_dna(rng, 400)
    s = random_dna(rng, 420)
    path = str(tmp_path / "hb.npz")
    hirschberg.align_hirschberg(q, s, Mode.GLOBAL, SC, device="cpu",
                                checkpoint_path=path)
    with pytest.raises(ValueError, match="does not match"):
        hirschberg.align_hirschberg(q, s[:-1], Mode.GLOBAL, SC, device="cpu",
                                    checkpoint_path=path)
