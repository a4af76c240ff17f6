"""The CUDA sources of anyseq_tpu_torch's kernels, compiled as C++ against
their host emulation (csrc/host_emu.h: each CTA's threads run as host
threads, CTAs one after another) and held against the plain versions.

This checks the kernels' index arithmetic, strip hand-off, staging ring,
code packing and tie order on a machine without a GPU; it cannot check
what only the card shows (the compiler for sm_90a, memory ordering
between concurrent CTAs, speed). chip_smoke.py does that on the card."""
import shutil
import subprocess

import numpy as np
import pytest
import torch

from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
from anyseq_tpu_torch.engine import batch
from anyseq_tpu_torch.kernels import _build, lastcols, swarm, walk, wavefront

SC = LinearScoring(2, -1, -1)
# the bench suite's affine scoring, and a free extension (ge = 0)
ASC = [AffineScoring(2, -1, -3, -1), AffineScoring(1, -6, -4, 0)]


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the host emulation")
    out = tmp_path_factory.mktemp("emu") / "libanyseq_emu.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O2", "-Wno-unknown-pragmas", "-x", "c++",
         "-DANYSEQ_HOST_EMU", "-shared", "-fPIC", "-pthread", "-o", str(out),
         *(str(_build.CSRC / name) for name in _build.SOURCES)],
        check=True)
    return _build.load(out)


def _seq(rng, n):
    return torch.from_numpy(rng.integers(65, 69, n).astype(np.uint8))


@pytest.mark.parametrize("preds", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("m,n", [(1, 1), (5, 17), (130, 1030), (64, 1024),
                                 (65, 2048), (300, 3100)])
def test_wavefront_kernel(emu_lib, m, n, mode, preds):
    """Ragged strips (n not a multiple of 1024), several strips, and row
    counts on both sides of the 64-row staging chunks."""
    rng = np.random.default_rng(m * n)
    q, s = _seq(rng, m), _seq(rng, n)
    got = wavefront.launch(emu_lib, q, s, mode, SC, preds)
    want = (wavefront.plain_preds if preds else wavefront.plain)(q, s, mode,
                                                                 SC)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("preds", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("case", ["self", "repeat"])
def test_wavefront_kernel_ties(emu_lib, case, mode, preds):
    """Equal maxima across threads and strips: self-alignment over two
    strips, and a repeat whose last row holds the maximum in every
    column past the diagonal (the first one must win)."""
    if case == "self":
        q = s = _seq(np.random.default_rng(1), 1500)
    else:
        q = torch.full((50,), 65, dtype=torch.uint8)
        s = torch.full((1500,), 65, dtype=torch.uint8)
    got = wavefront.launch(emu_lib, q, s, mode, SC, preds)
    want = (wavefront.plain_preds if preds else wavefront.plain)(q, s, mode,
                                                                 SC)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
def test_walk_kernel(emu_lib, mode):
    rng = np.random.default_rng(2)
    B, M, N = 9, 40, 300
    q = torch.from_numpy(rng.integers(65, 69, (B, M)).astype(np.uint8))
    s = torch.from_numpy(rng.integers(65, 69, (B, N)).astype(np.uint8))
    ms = torch.from_numpy(rng.integers(1, M + 1, B))
    ns = torch.from_numpy(rng.integers(1, N + 1, B))
    words, _ = batch.preds_batch(q, s, ms, ns, SC)
    ends = (torch.stack([ms, ns], 1) - 1).to(torch.int32)
    ends[0] = -1
    got = walk.launch(emu_lib, words, q, s, ends, mode)
    want = walk.plain(words, q, s, ends, mode)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,M,N", [(7, 90, 2500), (16, 33, 140), (1, 1, 1)])
def test_lastcols_kernel(emu_lib, B, M, N):
    rng = np.random.default_rng(B * M * N)
    q = torch.from_numpy(rng.integers(65, 69, (B, M)).astype(np.uint8))
    s = torch.from_numpy(rng.integers(65, 69, (B, N)).astype(np.uint8))
    ms = torch.from_numpy(rng.integers(1, M + 1, B))
    ns = torch.from_numpy(rng.integers(1, N + 1, B))
    ms[0], ns[0] = M, N
    got = lastcols.launch(emu_lib, q, s, ms, ns, SC)
    assert torch.equal(got, lastcols.plain(q, s, ms, ns, SC))


@pytest.mark.parametrize("sc", ASC, ids=str)
@pytest.mark.parametrize("preds", [False, True], ids=["K5", "K5p"])
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("m,n", [(1, 1), (5, 17), (130, 1030), (64, 1024),
                                 (65, 2048)])
def test_wavefront_affine_kernel(emu_lib, m, n, mode, preds, sc):
    """Ragged strips, several strips (H and E handed over), row counts on
    both sides of the 64-row staging chunks; GLOBAL score sweeps with and
    without start_gap, always with the E last column."""
    rng = np.random.default_rng(m * n + 1)
    q, s = _seq(rng, m), _seq(rng, n)
    if preds:
        cases = [(False, False)]
    else:
        cases = [(False, True)] + ([(True, True)] if mode is Mode.GLOBAL
                                   else [])
    for start_gap, col_e in cases:
        got = wavefront.launch_affine(emu_lib, q, s, mode, sc, preds,
                                      start_gap, col_e)
        if preds:
            want = wavefront.plain_affine_preds(q, s, mode, sc)
        else:
            want = wavefront.plain_affine(q, s, mode, sc, start_gap, col_e)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (k, start_gap)


@pytest.mark.parametrize("preds", [False, True], ids=["K5", "K5p"])
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("case", ["self", "repeat"])
def test_wavefront_affine_kernel_ties(emu_lib, case, mode, preds):
    """Equal maxima across threads and strips, as for K1."""
    if case == "self":
        q = s = _seq(np.random.default_rng(1), 1500)
    else:
        q = torch.full((50,), 65, dtype=torch.uint8)
        s = torch.full((1500,), 65, dtype=torch.uint8)
    sc = ASC[0]
    got = wavefront.launch_affine(emu_lib, q, s, mode, sc, preds, False,
                                  False)
    want = (wavefront.plain_affine_preds(q, s, mode, sc) if preds
            else wavefront.plain_affine(q, s, mode, sc))
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _flags(rng, B):
    return torch.from_numpy(rng.integers(0, 2, B).astype(bool))


@pytest.mark.parametrize("sc", ASC, ids=str)
@pytest.mark.parametrize("B,M,N", [(7, 90, 2500), (16, 33, 140), (1, 1, 1)])
def test_lastcols_affine_kernel(emu_lib, B, M, N, sc):
    """Many problems of ragged strips in one ticket list, mixed
    start_gap flags."""
    rng = np.random.default_rng(B * M * N + 3)
    q = torch.from_numpy(rng.integers(65, 69, (B, M)).astype(np.uint8))
    s = torch.from_numpy(rng.integers(65, 69, (B, N)).astype(np.uint8))
    ms = torch.from_numpy(rng.integers(1, M + 1, B))
    ns = torch.from_numpy(rng.integers(1, N + 1, B))
    ms[0], ns[0] = M, N
    sg = _flags(rng, B)
    got = lastcols.launch_affine(emu_lib, q, s, ms, ns, sc, sg)
    want = lastcols.plain_affine(q, s, ms, ns, sc, sg)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sc", ASC, ids=str)
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
def test_walk_affine_kernel(emu_lib, mode, sc):
    """Walks over terminal-stripe codes from each stripe's last cell with
    mixed start- and end-gap flags, one dead walk, and (GLOBAL) the
    full-traceback halo."""
    rng = np.random.default_rng(4)
    B, M, N = 9, 40, 300
    q = torch.from_numpy(rng.integers(65, 69, (B, M)).astype(np.uint8))
    s = torch.from_numpy(rng.integers(65, 69, (B, N)).astype(np.uint8))
    ms = torch.from_numpy(rng.integers(1, M + 1, B))
    ns = torch.from_numpy(rng.integers(1, N + 1, B))
    sg, eg = _flags(rng, B), _flags(rng, B)
    words, _, _ = batch.preds_batch_affine(q, s, ms, ns, sc, sg)
    ends = (torch.stack([ms, ns], 1) - 1).to(torch.int32)
    ends[0] = -1
    got = walk.launch_affine(emu_lib, words, q, s, ends, mode, sg, eg)
    want = walk.plain_affine(words, q, s, ends, mode, sg, eg)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sc", [SC, LinearScoring(3, -2, -2)] + ASC, ids=str)
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("B,M,N", [(1, 1, 1), (127, 30, 50), (129, 40, 17),
                                   (300, 20, 33)])
def test_swarm_kernel(emu_lib, B, M, N, mode, sc):
    """K7 with one CTA, a CTA edge on either side of 128 problems and three
    CTAs; ragged lengths with m = n = 1 problems; bytes past each length
    are real bases. Linear with and without codes, and LOCAL without
    positions; affine with mixed start-gap flags and ge = 0."""
    rng = np.random.default_rng(B * M * N + 5)
    q = torch.from_numpy(rng.integers(65, 69, (B, M)).astype(np.uint8))
    s = torch.from_numpy(rng.integers(65, 69, (B, N)).astype(np.uint8))
    ms = torch.from_numpy(rng.integers(1, M + 1, B))
    ns = torch.from_numpy(rng.integers(1, N + 1, B))
    ms[-1] = ns[-1] = 1
    ms[0], ns[0] = M, N
    affine = isinstance(sc, AffineScoring)
    sg = _flags(rng, B) if affine else None
    cases = [(True, False), (False, False)] + ([] if affine
                                               else [(True, True)])
    for need_pos, preds in cases:
        got = swarm.launch(emu_lib, q, s, ms, ns, mode, sc, sg, need_pos,
                           preds)
        want = swarm.plain(q, s, ms, ns, mode, sc, sg, need_pos, preds)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (k, need_pos, preds)


def test_reduce_best_order():
    """Per-strip first maxima reduce to the row-major first maximum."""
    bests = torch.tensor([[5, 9, 3], [7, 4, 2000], [7, 4, 1100], [7, 6, 1]],
                         dtype=torch.int32)
    assert wavefront.reduce_best(bests).tolist() == [7, 4, 1100]
