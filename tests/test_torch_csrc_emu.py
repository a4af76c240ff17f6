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

from anyseq_tpu_torch.core.types import LinearScoring, Mode
from anyseq_tpu_torch.engine import batch
from anyseq_tpu_torch.kernels import _build, lastcols, walk, wavefront

SC = LinearScoring(2, -1, -1)


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


def test_reduce_best_order():
    """Per-strip first maxima reduce to the row-major first maximum."""
    bests = torch.tensor([[5, 9, 3], [7, 4, 2000], [7, 4, 1100], [7, 6, 1]],
                         dtype=torch.int32)
    assert wavefront.reduce_best(bests).tolist() == [7, 4, 1100]
