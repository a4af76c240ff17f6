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
from anyseq_tpu_torch.engine import affine, batch, linmem
from anyseq_tpu_torch.kernels import (
    _build,
    band,
    lastcols,
    swarm,
    walk,
    wavefront,
)
from anyseq_tpu_torch.utils import debug

SC = LinearScoring(2, -1, -1)
# the bench suite's affine scoring, and a free extension (ge = 0)
ASC = [AffineScoring(2, -1, -3, -1), AffineScoring(1, -6, -4, 0)]
# the edges of the affine chain: a free extension, and a free opening
ASC_EDGES = [AffineScoring(1, -6, -4, 0), AffineScoring(2, -1, 0, -1)]


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


def _dp_state(q, s, mode, sc, cells: int = 400) -> str:
    """A failure message's whole plain DP state of a small pair (of a
    larger one, its shape)."""
    if q.numel() * s.numel() > cells:
        return f"{q.numel()}x{s.numel()} (too large to print its DP state)"
    return "\n" + debug.format_dp_state(q.numpy(), s.numpy(), mode, sc)


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
        assert torch.equal(got[k], want[k]), (k, _dp_state(q, s, mode, SC))


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
            assert torch.equal(got[k], want[k]), (
                k, start_gap, _dp_state(q, s, mode, sc))


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


# The walks' windows (csrc/walk_core.cuh) hold 96 rows of 112 columns and
# are prefetched 32 steps ahead: problems several windows tall and wide,
# gap runs longer than two windows, walks along the GLOBAL halo, stripes
# with dead walks, and a full traceback of (m + n) % 256 == 0.
WALK_CASES = ["300x450", "gap runs", "halo", "stripes", "len256"]


def _walk_case(case, affine):
    """(words, q, s, ends, sgap, egap) of a walk case: GLOBAL stripe codes
    (``preds_batch``), or (len256) one full-traceback matrix."""
    rng = np.random.default_rng(WALK_CASES.index(case) + 10 * affine)
    sc = ASC[0] if affine else SC

    def dna(n):
        return rng.integers(65, 69, n).astype(np.uint8)

    if case == "len256":
        q, s = torch.from_numpy(dna(100)), torch.from_numpy(dna(156))
        outs = (wavefront.plain_affine_preds(q, s, Mode.GLOBAL, sc) if affine
                else wavefront.plain_preds(q, s, Mode.GLOBAL, sc))
        end = linmem.extract_end(outs, 100, 156, Mode.GLOBAL)[None, 1:]
        flags = torch.zeros(1, dtype=torch.bool)
        return (outs["preds"][None], q[None], s[None], end.to(torch.int32),
                flags, flags)
    if case == "300x450":
        pairs = [(dna(int(rng.integers(200, 301))),
                  dna(int(rng.integers(250, 451)))) for _ in range(5)]
    elif case == "gap runs":
        # a horizontal run of 300 columns and a vertical one of 200 rows:
        # inserts of a byte that matches nothing
        a, b = dna(300), dna(300)
        x, z = np.full(300, ord("X"), np.uint8), np.full(200, ord("Z"),
                                                         np.uint8)
        pairs = [(a, np.concatenate([a[:150], x, a[150:]])),
                 (np.concatenate([b[:100], z, b[100:]]), b)]
    elif case == "halo":
        # q a suffix of s: the walk reaches row -1 near column 350; s a
        # suffix of q: column -1 near row 330
        a = dna(400)
        pairs = [(a[350:], a), (a, a[330:]), (a[380:], dna(40))]
    else:
        pairs = [(dna(int(rng.integers(1, 257))), dna(int(rng.integers(1, 257))))
                 for _ in range(9)]
    B = len(pairs)
    M = max(len(x) for x, _ in pairs)
    N = max(len(y) for _, y in pairs)
    q = torch.from_numpy(rng.integers(65, 69, (B, M)).astype(np.uint8))
    s = torch.from_numpy(rng.integers(65, 69, (B, N)).astype(np.uint8))
    for b, (x, y) in enumerate(pairs):
        q[b, :len(x)] = torch.from_numpy(x)
        s[b, :len(y)] = torch.from_numpy(y)
    ms = torch.tensor([len(x) for x, _ in pairs])
    ns = torch.tensor([len(y) for _, y in pairs])
    sg, eg = _flags(rng, B), _flags(rng, B)
    if affine:
        words, _, _ = batch.preds_batch_affine(q, s, ms, ns, sc, sg)
    else:
        words, _ = batch.preds_batch(q, s, ms, ns, SC)
    ends = (torch.stack([ms, ns], 1) - 1).to(torch.int32)
    if case == "stripes":
        ends[[0, 4, 8]] = -1
    return words, q, s, ends, sg, eg


@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_kernel_windows(emu_lib, case, mode):
    """K3 across windows, against its plain version."""
    words, q, s, ends, _, _ = _walk_case(case, False)
    got = walk.launch(emu_lib, words, q, s, ends, mode)
    want = walk.plain(words, q, s, ends, mode)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_affine_kernel_windows(emu_lib, case, mode):
    """K6 across windows (E and F runs longer than two windows, mixed
    start- and end-gap flags), against its plain version."""
    words, q, s, ends, sg, eg = _walk_case(case, True)
    got = walk.launch_affine(emu_lib, words, q, s, ends, mode, sg, eg)
    want = walk.plain_affine(words, q, s, ends, mode, sg, eg)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("affine", [False, True], ids=["K3", "K6"])
def test_walk_kernel_windows_match_xla(emu_lib, affine):
    """A window-crossing stripe batch: the port's terminal pred sweep and
    the emulated walk give the strings of the JAX package's
    ``preds_walk_batch`` (``_affine``) on XLA:CPU."""
    import jax.numpy as jnp

    from anyseq_tpu.core.types import AffineScoring as JaxAffine
    from anyseq_tpu.core.types import LinearScoring as JaxLinear
    from anyseq_tpu.engine import batch as jax_batch

    words, q, s, ends, sg, eg = _walk_case("gap runs", affine)
    B, M = q.shape
    N = s.shape[1]
    ms, ns = ends[:, 0] + 1, ends[:, 1] + 1
    jargs = (jnp.asarray(q.numpy(), jnp.int32),
             jnp.asarray(s.numpy(), jnp.int32), jnp.asarray(ms.numpy()),
             jnp.asarray(ns.numpy()))
    if affine:
        ref_q, ref_s, _ = jax_batch.preds_walk_batch_affine(
            *jargs, JaxAffine(2, -1, -3, -1), jnp.asarray(sg.numpy()),
            jnp.asarray(eg.numpy()))
        got = walk.launch_affine(emu_lib, words, q, s, ends, Mode.GLOBAL,
                                 sg, eg)
    else:
        ref_q, ref_s = jax_batch.preds_walk_batch(*jargs,
                                                  JaxLinear(2, -1, -1))
        got = walk.launch(emu_lib, words, q, s, ends, Mode.GLOBAL)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(ref_q)[:, :M + N])
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(ref_s)[:, :M + N])


@pytest.mark.parametrize("sc", [SC, LinearScoring(3, -2, -2)] + ASC, ids=str)
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("B,M,N", [(1, 1, 1), (127, 30, 50), (129, 40, 17),
                                   (300, 20, 33)])
def test_swarm_kernel(emu_lib, B, M, N, mode, sc):
    """K7 with one CTA, a CTA edge on either side of 128 problems and three
    CTAs; ragged lengths with m = n = 1 problems; bytes past each length
    are real bases. With and without codes (2-bit linear, 4-bit affine),
    and LOCAL without positions; affine with mixed start-gap flags and
    ge = 0."""
    rng = np.random.default_rng(B * M * N + 5)
    q = torch.from_numpy(rng.integers(65, 69, (B, M)).astype(np.uint8))
    s = torch.from_numpy(rng.integers(65, 69, (B, N)).astype(np.uint8))
    ms = torch.from_numpy(rng.integers(1, M + 1, B))
    ns = torch.from_numpy(rng.integers(1, N + 1, B))
    ms[-1] = ns[-1] = 1
    ms[0], ns[0] = M, N
    affine = isinstance(sc, AffineScoring)
    sg = _flags(rng, B) if affine else None
    cases = [(True, False), (False, False), (True, True)]
    for need_pos, preds in cases:
        got = swarm.launch(emu_lib, q, s, ms, ns, mode, sc, sg, need_pos,
                           preds)
        want = swarm.plain(q, s, ms, ns, mode, sc, sg, need_pos, preds)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (k, need_pos, preds)


def _swarm_batch(rng, shapes, alphabet=b"ACGT"):
    """Random problems of the given (m, n) shapes, padded with real
    symbols, and their lengths."""
    ms = torch.tensor([m for m, _ in shapes])
    ns = torch.tensor([n for _, n in shapes])
    sym = np.frombuffer(alphabet, np.uint8)
    q = sym[rng.integers(0, len(sym), (len(shapes), int(ms.max())))]
    s = sym[rng.integers(0, len(sym), (len(shapes), int(ns.max())))]
    return torch.from_numpy(q), torch.from_numpy(s), ms, ns


def _check_swarm(lib, q, s, ms, ns, sc, sg, width=0, modes=tuple(Mode),
                 cases=((True, False), (False, False), (True, True))):
    """K7 at `width` (0: the rule's) against its plain version, in `modes`,
    score-only, without positions and with codes (at a width that has
    them)."""
    affine = isinstance(sc, AffineScoring)
    for mode in modes:
        for need_pos, preds in cases:
            if preds and width and width not in swarm.widths_of(affine,
                                                               True):
                continue
            args = (q, s, ms, ns, mode, sc, sg, need_pos, preds)
            got = swarm.launch(lib, *args, width=width)
            want = swarm.plain(*args)
            assert got.keys() == want.keys()
            for k in want:
                assert torch.equal(got[k], want[k]), (k, mode, need_pos,
                                                      preds)


_SWARM_WIDTHS = ([(SC, w) for w in swarm.WIDTHS]
                 + [(ASC[0], w) for w in swarm.AFFINE_WIDTHS])


@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("sc,width", _SWARM_WIDTHS,
                         ids=lambda x: str(x) if isinstance(x, int) else
                         type(x).__name__)
def test_swarm_kernel_widths(emu_lib, sc, width, mode):
    """K7 on the warp strip cores forced to each width: problems of n = 1,
    31, 32 W - 1, 32 W and 32 W + 1 columns (one strip, a strip's edge,
    two strips) by m = 1, 17 and 33 rows (fewer and more than a warp's
    lanes), a tall one and a wide one; affine with mixed start-gap
    flags."""
    rng = np.random.default_rng(width + 3 * isinstance(sc, AffineScoring))
    strip = 32 * width
    shapes = [(m, n) for m in (1, 17, 33)
              for n in (1, 31, strip - 1, strip, strip + 1)]
    q, s, ms, ns = _swarm_batch(rng, shapes + [(200, 20), (9, strip * 3)])
    sg = _flags(rng, len(shapes) + 2) if isinstance(sc, AffineScoring) \
        else None
    _check_swarm(emu_lib, q, s, ms, ns, sc, sg, width=width, modes=(mode,))


@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("sc", [SC] + ASC + ASC_EDGES[1:], ids=str)
def test_swarm_kernel_mixed_strips(emu_lib, sc, mode):
    """One launch of problems of one to five strips (at the rule's width
    and at the narrowest), multi-strip problems handing their boundary
    columns on; affine with mixed start-gap flags, ge = 0 and go = 0."""
    rng = np.random.default_rng(7)
    shapes = list(zip(rng.integers(1, 81, 24), rng.integers(1, 1300, 24)))
    q, s, ms, ns = _swarm_batch(rng, shapes)
    affine = isinstance(sc, AffineScoring)
    sg = _flags(rng, len(shapes)) if affine else None
    for width in (0, swarm.widths_of(affine, True)[-1]):
        _check_swarm(emu_lib, q, s, ms, ns, sc, sg, width=width,
                     modes=(mode,))


@pytest.mark.parametrize("kind", ["runs", "single matches"])
@pytest.mark.parametrize("sc,width", _SWARM_WIDTHS,
                         ids=lambda x: str(x) if isinstance(x, int) else
                         type(x).__name__)
def test_swarm_kernel_local_ties(emu_lib, sc, width, kind):
    """Equal LOCAL maxima across lanes, rows and strips: runs of one
    symbol (the maximum along a whole row, over strips) and, at -100 for
    a mismatch or a gap, single matches among 20 symbols (maxima of 1 all
    over the matrix); the first in row-major order wins."""
    rng = np.random.default_rng(width)
    shapes = [(m, n) for m in (1, 5, 40) for n in (3, 40, 300, 700)]
    if kind == "runs":
        q, s, ms, ns = _swarm_batch(rng, shapes, b"A")
    else:
        q, s, ms, ns = _swarm_batch(rng, shapes, b"ACDEFGHIKLMNPQRSTVWY")
        sc = (AffineScoring(1, -100, -100, -1) if isinstance(
            sc, AffineScoring) else LinearScoring(1, -100, -100))
    _check_swarm(emu_lib, q, s, ms, ns, sc, None, width=width,
                 modes=(Mode.LOCAL,))


@pytest.mark.parametrize("affine", [False, True], ids=["K3", "K6"])
def test_swarm_codes_walked_match_xla(emu_lib, affine):
    """GLOBAL stripes of one to four strips: the emulated K7's codes,
    walked by the emulated K3 (K6, with mixed start-gap flags), give the
    strings of the JAX package's ``preds_walk_batch`` (``_affine``, with
    its scores) on XLA:CPU."""
    import jax.numpy as jnp

    from anyseq_tpu.core.types import AffineScoring as JaxAffine
    from anyseq_tpu.core.types import LinearScoring as JaxLinear
    from anyseq_tpu.engine import batch as jax_batch

    rng = np.random.default_rng(11)
    shapes = list(zip(rng.integers(1, 120, 10), rng.integers(1, 1000, 10)))
    q, s, ms, ns = _swarm_batch(rng, shapes)
    B, M = q.shape
    N = s.shape[1]
    sg, eg = _flags(rng, B), _flags(rng, B)
    sc = ASC[0] if affine else SC
    res = swarm.launch(emu_lib, q, s, ms, ns, Mode.GLOBAL, sc,
                       sg if affine else None, True, True, width=8)
    ends = (torch.stack([ms, ns], 1) - 1).to(torch.int32)
    jargs = (jnp.asarray(q.numpy(), jnp.int32),
             jnp.asarray(s.numpy(), jnp.int32), jnp.asarray(ms.numpy()),
             jnp.asarray(ns.numpy()))
    if affine:
        ref_q, ref_s, ref_scores = jax_batch.preds_walk_batch_affine(
            *jargs, JaxAffine(2, -1, -3, -1), jnp.asarray(sg.numpy()),
            jnp.asarray(np.zeros(B, bool)))
        got = walk.launch_affine(emu_lib, res["preds"], q, s, ends,
                                 Mode.GLOBAL, sg, torch.zeros(B, dtype=bool))
        np.testing.assert_array_equal(res["best"][:, 0].numpy(),
                                      np.asarray(ref_scores))
    else:
        ref_q, ref_s = jax_batch.preds_walk_batch(*jargs,
                                                  JaxLinear(2, -1, -1))
        got = walk.launch(emu_lib, res["preds"], q, s, ends, Mode.GLOBAL)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(ref_q)[:, :M + N])
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(ref_s)[:, :M + N])


def _band_case(q, s, i0, mode, sc, start_gap=False):
    """The arguments of a band of rows [i0, len(q)) whose top row comes
    from the plain sweep of the rows above (the F row too, affine)."""
    n, h = s.shape[0], q.shape[0] - i0
    if isinstance(sc, AffineScoring):
        top = affine._band(q[:i0], s, *affine.top_row_affine(
            mode, sc, n, start_gap, s.device), *affine.left_col_affine(
                mode, sc, 0, i0, start_gap, s.device), mode, sc, False)
        corner, col, cole = affine.left_col_affine(mode, sc, i0, h,
                                                   start_gap, s.device)
        return (q[i0:], s, top["last_row"], top["last_row_f"], corner, col,
                cole, mode, sc)
    top = linmem.score_band(q[:i0], s, linmem.top_row(mode, sc, n, s.device),
                            *linmem.left_col(mode, sc, 0, i0, s.device),
                            mode, sc)
    return (q[i0:], s, top["last_row"],
            *linmem.left_col(mode, sc, i0, h, s.device), mode, sc)


def _check_band(lib, args, grid):
    if isinstance(args[-1], AffineScoring):
        got = band.launch_affine(lib, *args, grid=grid)
        want = band.plain_affine(*args)
    else:
        got = band.launch(lib, *args, grid=grid)
        want = band.plain(*args)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("sc", [SC] + ASC, ids=str)
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("i0,h,n", [(300, 130, 2500), (70, 64, 1024),
                                    (5, 1, 1), (40, 65, 3100)])
def test_band_kernel(emu_lib, i0, h, n, mode, sc):
    """K8 / K8 affine from the top row of the plain sweep above: several
    ragged strips (n not a multiple of 1024) with fewer CTAs than strips
    (the host emulation runs one CTA; grid=2 caps a launch the same way
    on the card), row counts on both sides of the 64-row staging chunks;
    GLOBAL affine bands also under the Myers-Miller start_gap boundary."""
    rng = np.random.default_rng(i0 * h + n)
    q, s = _seq(rng, i0 + h), _seq(rng, n)
    _check_band(emu_lib, _band_case(q, s, i0, mode, sc), grid=2)
    if isinstance(sc, AffineScoring) and mode is Mode.GLOBAL:
        _check_band(emu_lib, _band_case(q, s, i0, mode, sc, start_gap=True),
                    grid=0)


@pytest.mark.parametrize("sc", [SC, ASC[0]], ids=str)
@pytest.mark.parametrize("case", ["self", "repeat"])
def test_band_kernel_local_ties(emu_lib, case, sc):
    """Equal LOCAL maxima across threads and strips inside a band: the
    first in row-major order, counted from the band's top row."""
    if case == "self":
        q = s = _seq(np.random.default_rng(1), 1500)
        q = torch.cat([q[:300], q])
    else:
        q = torch.full((120,), 65, dtype=torch.uint8)
        s = torch.full((1500,), 65, dtype=torch.uint8)
    _check_band(emu_lib, _band_case(q, s, 60, Mode.LOCAL, sc), grid=0)


def test_reduce_best_order():
    """Per-strip first maxima reduce to the row-major first maximum."""
    bests = torch.tensor([[5, 9, 3], [7, 4, 2000], [7, 4, 1100], [7, 6, 1]],
                         dtype=torch.int32)
    assert wavefront.reduce_best(bests).tolist() == [7, 4, 1100]


@pytest.fixture
def emu_collective(emu_lib, monkeypatch):
    """The collective sweep's CPU branch routed to K10 of the host
    emulation (its ranks' launches run in rank order, each to its end
    before the next begins, as host_emu.h runs CTAs), 2 CTAs a launch."""
    monkeypatch.setattr(band, "plain_collective", lambda *a: (
        band.launch_collective(emu_lib, *a, grid=2)))
    monkeypatch.setattr(band, "plain_collective_affine", lambda *a: (
        band.launch_collective_affine(emu_lib, *a, grid=2)))


@pytest.mark.parametrize("sc", [SC] + ASC, ids=str)
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("k,m,n,band_rows", [
    (2, 70, 2500, None), (3, 130, 3100, 50), (4, 65, 2972, 64),
    (4, 5, 900, None)])
def test_band_collective_kernel(emu_collective, k, m, n, band_rows, mode,
                                sc):
    """K10 / K10 affine over k ranks, one launch a rank a band, against
    one plain sweep of the pair: halos between ranks (ragged strips, rows
    on both sides of the 64-row chunks), chained bands whose corner is
    the halo's, ranks past column n - 1 not launched (n = 2,972 over 4
    ranks, and n = 900, where only rank 0 has columns); affine GLOBAL also
    under start_gap; one launch counted a rank a band."""
    from anyseq_tpu_torch.dist import collective
    from anyseq_tpu_torch.dist.mesh import Mesh

    rng = np.random.default_rng(k * m * n)
    q, s = _seq(rng, m), _seq(rng, n)
    is_affine = isinstance(sc, AffineScoring)
    _, active, _, bands = collective.geometry(m, n, k, band_rows)
    for start_gap in ([False, True] if is_affine and mode is Mode.GLOBAL
                      else [False]):
        name = "band_collective_affine" if is_affine else "band_collective"
        before = _build.launches[name]
        got = collective.score_pair_collective(q, s, mode, sc,
                                               Mesh(["cpu"] * k, ("sp",)),
                                               band_rows=band_rows,
                                               start_gap=start_gap)
        assert _build.launches[name] - before == active * bands
        if is_affine:
            want = wavefront.plain_affine(q, s, mode, sc, start_gap, True)
            got.pop("last_row_f")
        else:
            want = wavefront.plain(q, s, mode, sc)
        assert got.keys() == want.keys()
        for key in want:
            assert torch.equal(got[key], want[key]), (key, start_gap)


@pytest.mark.parametrize("sc", [SC, ASC[0]], ids=str)
def test_band_collective_kernel_local_tie(emu_collective, sc):
    """Equal LOCAL maxima on both sides of a rank boundary (column 1024):
    the first in row-major order, from whichever rank holds it."""
    from anyseq_tpu_torch.dist import collective
    from anyseq_tpu_torch.dist.mesh import Mesh

    q = torch.full((40,), 65, dtype=torch.uint8)
    s = torch.full((2100,), 65, dtype=torch.uint8)
    got = collective.score_pair_collective(q, s, Mode.LOCAL, sc,
                                           Mesh(["cpu"] * 2, ("sp",)))
    want = (wavefront.plain_affine(q, s, Mode.LOCAL, sc)
            if isinstance(sc, AffineScoring)
            else wavefront.plain(q, s, Mode.LOCAL, sc))
    assert torch.equal(got["best"], want["best"])


@pytest.mark.parametrize("sc", [SC, ASC[0]], ids=str)
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
def test_band_collective_kernel_process_edge(emu_lib, mode, sc):
    """A process edge of the collective sweep (dist/collective.py), on the
    emulated K10 / K10 affine: the left rank writes each band's columns
    into a staging Halo, Halo.read copies them into host memory (one
    message a band, Halo.slot), and Halo.fill puts them into the right
    rank's halo with its flag raised before the right rank's launch,
    which then finds every row published and takes the corner of bands
    b > 0 from it; the two stripes equal one plain sweep."""
    from anyseq_tpu_torch.dist import collective

    m, n, rows, j0 = 70, 2100, 33, 1024
    rng = np.random.default_rng(13)
    q, s = _seq(rng, m), _seq(rng, n)
    is_affine = isinstance(sc, AffineScoring)
    bands = -(-m // rows)
    staging = band.Halo(m, bands, is_affine, "cpu", "cpu")
    halo = band.Halo(m, bands, is_affine, "cpu", "cpu")
    stage = staging.host_stage(False)
    if is_affine:
        row, rowf = affine.top_row_affine(mode, sc, n, False, "cpu")
    else:
        row, rowf = linmem.top_row(mode, sc, n, "cpu"), None
    stripes = [[row[:j0], None if rowf is None else rowf[:j0]],
               [row[j0:], None if rowf is None else rowf[j0:]]]
    cols, bests = [], []
    for b in range(bands):
        i0 = b * rows
        h = min(rows, m - i0)
        for k, (lo, hi) in enumerate(((0, j0), (j0, n))):
            if k == 0 and is_affine:
                corner, col, cole = affine.left_col_affine(mode, sc, i0, h,
                                                           False, "cpu")
            elif k == 0:
                (corner, col), cole = linmem.left_col(mode, sc, i0, h,
                                                      "cpu"), None
            else:
                corner = collective._top(mode, sc, j0 - 1, False) if b == 0 \
                    else None
                col = cole = None
            args = (q[i0:i0 + h], s[lo:hi], stripes[k][0], corner, col)
            halos = (halo if k else None, None if k else staging, b, i0)
            if is_affine:
                outs = band.launch_collective_affine(
                    emu_lib, *args[:2], args[2], stripes[k][1], corner, col,
                    cole, mode, sc, *halos, grid=2)
                stripes[k][1] = outs["last_row_f"]
            else:
                outs = band.launch_collective(emu_lib, *args, mode, sc,
                                              *halos, grid=2)
            stripes[k][0] = outs["last_row"]
            bests.append(outs["best"] + torch.tensor([0, i0, lo],
                                                     dtype=torch.int32))
            if k == 0:
                # the message: written by the left rank, read into host
                # memory, received into the right rank's halo
                slot = staging.slot(stage, i0, h)
                staging.read(i0, slot)
                message = slot.clone()
                halo.fill(b, i0, message)
                assert int(halo.flags[b]) == h
            else:
                cols.append(outs["last_col"])
    if is_affine:
        want = wavefront.plain_affine(q, s, mode, sc, False, True)
    else:
        want = wavefront.plain(q, s, mode, sc)
    assert torch.equal(torch.cat([stripes[0][0], stripes[1][0]]),
                       want["last_row"])
    assert torch.equal(torch.cat(cols), want["last_col"])
    if mode is Mode.LOCAL:
        assert torch.equal(band.reduce_best(torch.stack(bests)),
                           want["best"])


# --- K8 / K10 and their affine modes: the warp strip cores
# (csrc/band_sweep.cuh, csrc/band_sweep_affine.cuh) ---

_DPX_EDGES = [-2**31 + 1, -2**31 + 5, -2**30, -2**29 - 3, -2**29, -1000,
              -1, 0, 1, 7, 2**29, 2**30 + 11, 2**31 - 1]


def _wrap32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


_DPX = {
    "__viaddmax_s32": lambda a, b, c: max(_wrap32(a + b), c),
    "__viaddmax_s32_relu": lambda a, b, c: max(_wrap32(a + b), c, 0),
    "__vimax3_s32": lambda a, b, c: max(a, b, c),
}


@pytest.fixture(scope="module")
def dpx_table(tmp_path_factory):
    """Each emulated DPX intrinsic of host_emu.h on every triple of
    _DPX_EDGES, as printed by a small program built against it."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the host emulation")
    tmp = tmp_path_factory.mktemp("dpx")
    edges = ", ".join(f"{x}" for x in _DPX_EDGES)
    calls = "\n".join(
        f'  for (int a : e) for (int b : e) for (int c : e) '
        f'std::printf("{name} %d %d %d %d\\n", a, b, c, {name}(a, b, c));'
        for name in _DPX)
    src = tmp / "dpx.cpp"
    src.write_text(f'#include "host_emu.h"\nint main() {{\n'
                   f'  const int e[] = {{{edges}}};\n{calls}\n}}\n')
    exe = tmp / "dpx"
    subprocess.run([cxx, "-std=c++20", "-O2", "-pthread", "-DANYSEQ_HOST_EMU",
                    "-I", str(_build.CSRC), "-o", str(exe), str(src)],
                   check=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout
    table = {}
    for line in out.splitlines():
        name, *vals = line.split()
        table.setdefault(name, []).append(tuple(map(int, vals)))
    return table


@pytest.mark.parametrize("name", list(_DPX))
def test_emulated_dpx_intrinsics(dpx_table, name):
    """The host emulation's DPX intrinsics are their formulas, the add
    wrapping in 32 bits as on the card, at SCORE_MIN, -2**29, 0 and large
    positives."""
    rows = dpx_table[name]
    assert len(rows) == len(_DPX_EDGES) ** 3
    for a, b, c, got in rows:
        assert got == _DPX[name](a, b, c), (name, a, b, c)


@pytest.fixture
def emu_card(emu_lib):
    """Sets the emulated card's SMs and CTAs an SM (restored after)."""
    import ctypes

    fn = emu_lib.anyseq_emu_set_card
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], None
    yield fn
    fn(1, 1)


@pytest.mark.parametrize("kernel,sms,ctas,h,n,share,max_grid,want", [
    ("K8", 132, 4, 262_144, 1_000_000, 1, 0, 977),   # every strip at once
    ("K8", 132, 3, 262_144, 4_600_000, 1, 0, 1498),  # 4,493 strips: 3 rounds
    ("K8", 132, 4, 262_144, 4_600_000, 1, 0, 1498),
    ("K8", 132, 4, 262_144, 2_300_000, 2, 0, 749),   # two ranks, one card
    ("K8", 132, 4, 262_144, 500_000, 2, 0, 489),
    ("K8", 132, 4, 4096, 1_000_000, 1, 0, 66),       # ~67 strips busy at once
    ("K8", 132, 4, 700, 30_000, 2, 0, 10),       # 30 strips, 13 busy: 3 x 10
    ("K8", 132, 4, 262_144, 4_600_000, 1, 462, 462),  # the override
    ("K8", 132, 4, 4096, 4_600_000, 2, 5000, 1056),  # the rank's share
    ("K8", 4, 2, 2000, 20_000, 1, 0, 20),
    ("K8", 1, 1, 2000, 30_000, 1, 0, 4),       # 30 strips, 4 warps: 8 rounds
    ("K8", 1, 1, 2000, 3000, 1, 1, 1),
    # K8 affine: 512-column strips, 16 warps an SM (the 4 CTAs its 117
    # registers allow; fewer where a build holds fewer)
    # every strip at once (so too a K10 affine rank with a card to itself)
    ("K8 affine", 132, 4, 262_144, 1_000_000, 1, 0, 1954),
    ("K8 affine", 132, 4, 262_144, 2_200_000, 1, 0, 1433),  # 3 rounds
    ("K8 affine", 132, 2, 262_144, 1_000_000, 1, 0, 977),
    ("K8 affine", 132, 4, 262_144, 900_000, 1, 0, 1758),
    ("K8 affine", 132, 4, 262_144, 2_000_000, 1, 0, 1954),  # 2 rounds
    ("K8 affine", 132, 4, 262_144, 500_000, 2, 0, 977),     # the 1 Mbp mesh
    ("K8 affine", 132, 4, 262_144, 1_000_000, 2, 0, 977),
    ("K8 affine", 132, 4, 4096, 1_000_000, 1, 0, 66),
    ("K8 affine", 132, 4, 262_144, 1_000_000, 1, 462, 462),
    ("K8 affine", 132, 4, 4096, 4_600_000, 2, 5000, 1056),
])
def test_band_grid_rule(emu_card, emu_lib, kernel, sms, ctas, h, n, share,
                        max_grid, want):
    """anyseq_band_grid and anyseq_band_affine_grid (one rule, band_sweep.cuh
    grid_of, over each kernel's own CTAs an SM and strips of 1024 and 512
    columns): every strip at once where the card's share holds them all
    (CTAs of 4 warps) and the band keeps them busy (a strip starts 63
    steps after its left neighbour and runs h + 31), else as many warps
    as it holds or the band keeps busy, over equal rounds; max_grid
    overrides within the share."""
    emu_card(sms, ctas)
    for mode in Mode:
        fn = (emu_lib.anyseq_band_grid if kernel == "K8"
              else emu_lib.anyseq_band_affine_grid)
        got = fn(h, n, band.MODE_CODE[mode], share, max_grid)
        assert got == want, mode


@pytest.mark.parametrize("sc", [SC, ASC[0]], ids=str)
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("grid", [1, 2, 64])
@pytest.mark.parametrize("i0,h,n", [(9, 7, 2100), (40, 45, 3000),
                                    (33, 32, 1024), (5, 97, 2049)])
def test_band_kernel_warp_core(emu_card, emu_lib, i0, h, n, grid, mode, sc):
    """K8 and K8 affine on the warp cores: fewer rows than lanes, rows not
    a multiple of the 32-row publish chunk, ragged last strips (and a full
    one, n = 1024), with 1, 2 and more warps than strips (an emulated card
    of 4 SMs x 16 CTAs: a CTA's 4 warps run at once, each waiting on the
    strip to its left, and CTAs one after another); affine GLOBAL also
    under the Myers-Miller start_gap boundary."""
    emu_card(4, 16)
    rng = np.random.default_rng(i0 * h + n + grid)
    q, s = _seq(rng, i0 + h), _seq(rng, n)
    _check_band(emu_lib, _band_case(q, s, i0, mode, sc), grid=grid)
    if isinstance(sc, AffineScoring) and mode is Mode.GLOBAL:
        _check_band(emu_lib, _band_case(q, s, i0, mode, sc, start_gap=True),
                    grid=grid)


@pytest.mark.parametrize("sc", [SC] + ASC_EDGES, ids=str)
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
def test_band_kernel_near_score_min(emu_lib, mode, sc):
    """K8: a band whose top row, corner and left column lie a little above
    SCORE_MIN (no sum leaves int32's range): the warp core's DPX chain
    gives the plain version's values. K8 affine: top rows H and F, corner
    and left columns H and E on both sides of NEG = -(2**29), with ge = 0
    and with go = 0, at 2,500 columns and at one: the T-form E chain, and
    E's NEG + go floor at the band's first column, give the plain
    version's values."""
    from anyseq_tpu_torch.core.types import NEG, SCORE_MIN

    rng = np.random.default_rng(12)
    h, n = 70, 2500
    q, s = _seq(rng, h), _seq(rng, n)

    def near(base, size):
        return torch.from_numpy(base + rng.integers(0, 500, size)
                                .astype(np.int32))

    if isinstance(sc, AffineScoring):
        # also one column, where the floor shows in last_col_e
        base = NEG - 250
        for w in (n, 1):
            args = (q, s[:w], near(base, w), near(base, w), base + 3,
                    near(base, h), near(base, h), mode, sc)
            _check_band(emu_lib, args, grid=0)
    else:
        base = SCORE_MIN + 2**20
        args = (q, s, near(base, n), base + 3, near(base, h), mode, sc)
        _check_band(emu_lib, args, grid=0)


def _planted(plants, m=80, n=2200):
    """A query of A/C and a subject of G/T (no symbol in common) with each
    (string, query end, subject end) planted: under match 1 and a
    mismatch and gap of -100, LOCAL scores a planted string's length at
    its two ends and nothing longer elsewhere."""
    rng = np.random.default_rng(3)
    q = np.frombuffer(b"AC", np.uint8)[rng.integers(0, 2, m)].copy()
    s = np.frombuffer(b"GT", np.uint8)[rng.integers(0, 2, n)].copy()
    for text, qi, sj in plants:
        b = np.frombuffer(text, np.uint8)
        q[qi - len(b) + 1:qi + 1] = b
        s[sj - len(b) + 1:sj + 1] = b
    return torch.from_numpy(q), torch.from_numpy(s)


_X, _Y = b"ACGTTGCAAGTC", b"TTGACCAGTGCA"


@pytest.mark.parametrize("plants,want", [
    # one row, two strips (warps): the earlier column wins
    ([(_X, 40, 1500), (_X, 40, 700)], (40, 700)),
    # an earlier row in the later strip wins over a later row before it
    ([(_X, 40, 1500), (_Y, 60, 700)], (40, 1500)),
    # one warp: one row across lanes, then an earlier row in a later lane
    ([(_X, 50, 900), (_X, 50, 300)], (50, 300)),
    ([(_X, 50, 100), (_Y, 45, 900)], (45, 900)),
])
@pytest.mark.parametrize("sc", [LinearScoring(1, -100, -100),
                                AffineScoring(1, -100, -100, -100)], ids=str)
def test_band_kernel_local_ties_lanes_warps(emu_lib, plants, want, sc):
    """Equal LOCAL maxima across the lanes of one warp and across warps
    (strips), K8 and K8 affine: the first in row-major order, i counted
    from the band's top row (i0 = 20)."""
    q, s = _planted(plants)
    i0 = 20
    args = _band_case(q, s, i0, Mode.LOCAL, sc)
    affine = isinstance(sc, AffineScoring)
    got = (band.launch_affine if affine else band.launch)(emu_lib, *args)
    assert got["best"].tolist() == [12, want[0] - i0, want[1]]
    for k, v in (band.plain_affine if affine else band.plain)(*args).items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("sc", [SC, ASC[0]], ids=str)
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("k,m,n,band_rows", [(2, 70, 900, 33),
                                             (3, 45, 2000, 33),
                                             (3, 100, 2000, None)])
def test_band_collective_kernel_empty_last_rank(emu_collective, k, m, n,
                                                band_rows, mode, sc):
    """K10 and K10 affine on the warp cores over 2 and 3 ranks whose last
    rank has no columns (not launched), bands of 33 rows (chained
    corners, rows not a multiple of the 32-row chunk) and one band."""
    from anyseq_tpu_torch.dist import collective
    from anyseq_tpu_torch.dist.mesh import Mesh

    rng = np.random.default_rng(k * m + n)
    q, s = _seq(rng, m), _seq(rng, n)
    _, active, _, bands = collective.geometry(m, n, k, band_rows)
    assert active == k - 1
    affine = isinstance(sc, AffineScoring)
    name = "band_collective_affine" if affine else "band_collective"
    before = _build.launches[name]
    got = collective.score_pair_collective(q, s, mode, sc,
                                           Mesh(["cpu"] * k, ("sp",)),
                                           band_rows=band_rows)
    assert _build.launches[name] - before == active * bands
    if affine:
        want = wavefront.plain_affine(q, s, mode, sc, False, True)
        got.pop("last_row_f")
    else:
        want = wavefront.plain(q, s, mode, sc)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


# --- K1 / K5, the single-pair score sweeps, and K2 / K5p, the same
# sweeps with codes, on the warp strip cores at each strip width
# (csrc/band.cu anyseq_sweep, csrc/band_affine.cu anyseq_sweep_affine) ---

_SWEEP_WIDTHS = ([("K1", w) for w in band.WIDTHS]
                 + [("K5", w) for w in band.AFFINE_WIDTHS]
                 + [("K2", w) for w in band.CODE_WIDTHS]
                 + [("K5p", w) for w in band.AFFINE_CODE_WIDTHS])
_AFFINE = {"K5", "K5p"}
_CODES = {"K2", "K5p"}


def _check_sweep(lib, q, s, mode, sc, width, start_gap=False, grid=0,
                 preds=False):
    """K1 / K5 (`preds`: K2 / K5p) at `width` columns a lane against the
    plain version (affine with the E last column), every output bit for
    bit."""
    if isinstance(sc, AffineScoring):
        got = wavefront.launch_affine(lib, q, s, mode, sc, preds, start_gap,
                                      True, width=width, grid=grid)
        want = wavefront.plain_affine(q, s, mode, sc, start_gap, True)
        if preds:
            want["preds"] = wavefront.plain_affine_preds(q, s, mode,
                                                         sc)["preds"]
    else:
        got = wavefront.launch(lib, q, s, mode, sc, preds, width=width,
                               grid=grid)
        want = (wavefront.plain_preds if preds else wavefront.plain)(
            q, s, mode, sc)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), (
            k, width, start_gap, grid, _dp_state(q, s, mode, sc))
    return got


@pytest.mark.parametrize("shape", ["one column", "below a lane",
                                   "one row past a strip", "past a strip",
                                   "two full strips", "three strips"])
@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("kernel,width", _SWEEP_WIDTHS)
def test_sweep_kernel_widths(emu_card, emu_lib, kernel, width, mode, shape):
    """K1 and K5, and with codes K2 and K5p, forced to each width they
    have, 3 modes (K5 and K5p at both bench scorings, K5's GLOBAL also
    under the Myers-Miller start_gap): one
    column, fewer columns than a lane holds, one row, one column past a
    strip (rows past two 32-row chunks), two strips whose last is full
    (column n - 1 in the last lane's last column), and three ragged
    strips, also swept by one warp (an emulated card of 2 SMs x 4
    CTAs)."""
    emu_card(2, 4)
    strip = 32 * width
    m, n = {"one column": (5, 1), "below a lane": (33, max(width - 1, 1)),
            "one row past a strip": (1, strip + 1),
            "past a strip": (70, strip + 1),
            "two full strips": (45, 2 * strip),
            "three strips": (40, 2 * strip + 17)}[shape]
    rng = np.random.default_rng(m * n + width)
    q, s = _seq(rng, m), _seq(rng, n)
    grids = [0, 1] if shape == "three strips" else [0]
    for sc in ASC if kernel in _AFFINE else [SC]:
        for start_gap in ([False, True] if kernel == "K5"
                          and mode is Mode.GLOBAL else [False]):
            for grid in grids:
                _check_sweep(emu_lib, q, s, mode, sc, width, start_gap, grid,
                             preds=kernel in _CODES)


def _tie_cases(width):
    """(plants, (i, j) of the first maximum) of LOCAL ties for strips of
    `width` columns a lane: inside one lane (one row), across lanes,
    across strips, and an earlier row against an earlier column."""
    lane, strip = width, 32 * width
    at = strip + 3 * lane              # the first column of a lane
    return {
        # (AC)*6 in the query, (AC)*7 in the subject: twelve matches end at
        # columns at and at + 2 of one row, in one lane
        "in a lane": ([(b"AC" * 6, 40, at), (b"AC" * 7, None, at + 2)],
                      (40, at)),
        "across lanes": ([(_X, 50, strip + 5 * lane - 1),
                          (_X, 50, strip + 2 * lane - 1)],
                         (50, strip + 2 * lane - 1)),
        "earlier row, later lane": ([(_X, 40, strip + 6 * lane - 1),
                                     (_Y, 60, strip + lane - 1)],
                                    (40, strip + 6 * lane - 1)),
        "across strips": ([(_X, 40, 2 * strip + 20), (_X, 40, 31)],
                          (40, 31)),
        "earlier row, later strip": ([(_X, 40, 2 * strip + 30),
                                      (_Y, 60, strip + 30)],
                                     (40, 2 * strip + 30)),
    }


@pytest.mark.parametrize("case", list(_tie_cases(4)))
@pytest.mark.parametrize("kernel,width", _SWEEP_WIDTHS)
def test_sweep_kernel_local_ties(emu_lib, kernel, width, case):
    """Equal LOCAL maxima planted inside one lane, across lanes and across
    strips, at each width of K1 and K5 (and, codes on, K2 and K5p): the
    first in row-major order."""
    plants, want = _tie_cases(width)[case]
    q, s = _planted([p for p in plants if p[1] is not None],
                    n=3 * 32 * width)
    for text, qi, sj in plants:
        if qi is None:     # a subject plant only
            s[sj - len(text) + 1:sj + 1] = torch.frombuffer(
                bytearray(text), dtype=torch.uint8)
        else:              # a symbol of neither sequence on either side
            q[qi - len(text)] = q[qi + 1] = ord("N")
    sc = (AffineScoring(1, -100, -100, -100) if kernel in _AFFINE
          else LinearScoring(1, -100, -100))
    got = _check_sweep(emu_lib, q, s, Mode.LOCAL, sc, width,
                       preds=kernel in _CODES)
    assert got["best"].tolist() == [12, *want]


@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("sc", ASC_EDGES, ids=str)
@pytest.mark.parametrize("width", band.AFFINE_WIDTHS)
def test_sweep_kernel_affine_column0(emu_lib, width, sc, mode):
    """K5 at each width with a free extension (ge = 0) and a free opening
    (go = 0): E's NEG + go floor at column 0 (also under start_gap), the E
    column out of the lane that holds column n - 1 (one column, one past a
    strip) and the chain's carry E - go - ge where go + ge is 0 or
    -1."""
    _affine_column0(emu_lib, width, sc, mode, preds=False)


@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("sc", ASC_EDGES, ids=str)
@pytest.mark.parametrize("width", band.AFFINE_CODE_WIDTHS)
def test_sweep_kernel_affine_column0_codes(emu_lib, width, sc, mode):
    """K5p likewise: also the PE bit of column 0, which E[i][-1] = NEG + go
    - ge sets as the plain version does where ge or go is 0."""
    _affine_column0(emu_lib, width, sc, mode, preds=True)


def _affine_column0(lib, width, sc, mode, preds):
    rng = np.random.default_rng(width + 7)
    for m, n in ((30, 1), (30, 32 * width + 1), (70, 100)):
        q, s = _seq(rng, m), _seq(rng, n)
        for start_gap in ([False, True] if mode is Mode.GLOBAL and not preds
                          else [False]):
            _check_sweep(lib, q, s, mode, sc, width, start_gap, preds=preds)


def test_sweep_kernel_refuses_other_widths(emu_lib):
    """A width K1, K2, K5 or K5p does not have (K1 has no 4 columns a
    lane, which K5 has; K2 no 32, which K1 has), and K5p under start_gap:
    the launch is refused, and the wrapper raises."""
    q = _seq(np.random.default_rng(0), 10)
    for width, preds in ((12, False), (4, False), (32, True), (4, True)):
        with pytest.raises(RuntimeError, match="launch failed"):
            wavefront.launch(emu_lib, q, q, Mode.LOCAL, SC, preds,
                             width=width)
    for width, preds, start_gap in ((32, False, False), (32, True, False),
                                    (12, True, False), (8, True, True)):
        with pytest.raises(RuntimeError, match="launch failed"):
            wavefront.launch_affine(emu_lib, q, q, Mode.GLOBAL, ASC[0],
                                    preds, start_gap, False, width=width)


@pytest.mark.parametrize("kernel,sms,ctas,h,n,want", [
    # K1, one row a lane a step: 8 columns a lane at the 100k pair, the
    # 100k construction's passes and halves and the 1k pair; 16 where 8
    # would give twice the warps 2 an SM asks for; the 512 Ki x 1 M
    # one-piece sweep at 32 (977 warps)
    ("K1", 132, 4, 100_000, 100_064, 8),
    ("K1", 132, 4, 50_032, 100_000, 8),
    ("K1", 132, 4, 25_016, 50_032, 8),     # no width fills: least fill
    ("K1", 132, 4, 1000, 1011, 8),
    ("K1", 132, 4, 100_000, 200_000, 16),
    ("K1", 132, 4, 524_288, 1_000_000, 32),
    ("K1", 132, 1, 524_288, 1_000_000, 32),
    ("K1", 132, 4, 5, 100_000, 32),        # every fill too long: widest
    ("K1", 132, 4, 1, 1, 8),
    ("K1", 4, 4, 2000, 20_000, 32),        # a small card fills sooner
    # K5, two rows a lane a step: 8 at the 100k pair and the 1k pair, 4 at
    # the 100k construction's halves, 16 at 512 Ki x 1 M
    ("K5", 132, 4, 100_000, 100_064, 8),
    ("K5", 132, 4, 100_000, 50_032, 4),
    ("K5", 132, 4, 50_032, 25_016, 4),
    ("K5", 132, 4, 1000, 1011, 8),
    ("K5", 132, 4, 524_288, 1_000_000, 16),
    ("K5", 132, 1, 524_288, 1_000_000, 16),
    ("K5", 132, 4, 5, 100_000, 16),
    ("K5", 4, 4, 2000, 20_000, 16),
    # K2 and K5p, by the level rule on their own step costs (K2 16 and 8
    # columns a lane, ~450 + 46 cycles a column; K5p 16 one row a step,
    # ~545 + 63, 8 and 4 two rows, ~950 + 100): K2 8 at every pair but a
    # 5-row one, whose 16-column strips' shorter fill wins; K5p 4 where its
    # fill, 47 steps a strip, stays short against the rows, 8 at 2,000 x
    # 3,000, 16 at 5 rows
    ("K2", 132, 4, 10_000, 10_000, 8),
    ("K2", 132, 4, 2048, 2048, 8),
    ("K2", 132, 4, 2000, 3000, 8),
    ("K2", 132, 4, 256, 256, 8),
    ("K2", 132, 4, 100_000, 200_000, 8),
    ("K2", 4, 4, 2000, 20_000, 8),
    ("K2", 132, 4, 5, 100_000, 16),
    ("K5p", 132, 4, 10_000, 10_000, 4),
    ("K5p", 132, 4, 2048, 2048, 4),
    ("K5p", 132, 4, 2000, 3000, 8),
    ("K5p", 132, 4, 256, 256, 4),
    ("K5p", 132, 4, 100_000, 100_000, 4),
    ("K5p", 132, 4, 5, 100_000, 16),
])
def test_sweep_width_rule(emu_card, emu_lib, kernel, sms, ctas, h, n, want):
    """anyseq_sweep_width and anyseq_sweep_affine_width on emulated cards:
    K1 and K5 by band_sweep.cuh width_of (the widest width whose launch
    runs 2 warps an SM, else the narrowest whose fill (strips - 1) x lag
    is at most half a strip's steps, else the widest), K2 and K5p by
    level_width on their own step costs (the least modelled time); the
    grid reported for the chosen width is that of grid_of."""
    emu_card(sms, ctas)
    affine, codes = kernel in _AFFINE, int(kernel in _CODES)
    width = (emu_lib.anyseq_sweep_affine_width if affine
             else emu_lib.anyseq_sweep_width)
    grid = (emu_lib.anyseq_sweep_affine_grid if affine
            else emu_lib.anyseq_sweep_grid)
    for mode in Mode:
        assert width(h, n, band.MODE_CODE[mode], codes) == want, mode
        assert grid(h, n, band.MODE_CODE[mode], want, codes) >= 1
    assert grid(h, n, 0, 12, codes) == -1


@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.value)
@pytest.mark.parametrize("kernel,width", [("K2", 8), ("K5p", 4)])
def test_sweep_codes_walked_match_xla(emu_lib, kernel, width, mode):
    """A ~200 x 300 pair (two or three strips): the emulated K2's (K5p's)
    codes, walked by the emulated K3 (K6) from the sweep's end cell, give
    the alignment of the JAX package's ``align_full_tb`` on XLA:CPU."""
    import anyseq_tpu
    from anyseq_tpu.core.types import AffineScoring as JaxAffine
    from anyseq_tpu.core.types import LinearScoring as JaxLinear

    rng = np.random.default_rng(13)
    q, s = _seq(rng, 203), _seq(rng, 297)
    m, n = q.shape[0], s.shape[0]
    affine = kernel == "K5p"
    sc = ASC[0] if affine else SC
    outs = (wavefront.launch_affine(emu_lib, q, s, mode, sc, True, False,
                                    False, width=width) if affine
            else wavefront.launch(emu_lib, q, s, mode, sc, True,
                                  width=width))
    end = linmem.extract_end(outs, m, n, mode)
    args = (outs["preds"][None], q[None], s[None], end[None, 1:], mode)
    if affine:
        no_gap = torch.zeros(1, dtype=torch.bool)
        out_q, out_s, start = walk.launch_affine(emu_lib, *args, no_gap,
                                                 no_gap)
        ref = anyseq_tpu.align_full_tb(q.numpy().tobytes(),
                                       s.numpy().tobytes(), mode.value,
                                       JaxAffine(2, -1, -3, -1))
    else:
        out_q, out_s, start = walk.launch(emu_lib, *args)
        ref = anyseq_tpu.align_full_tb(q.numpy().tobytes(),
                                       s.numpy().tobytes(), mode.value,
                                       JaxLinear(2, -1, -1))
    got = (int(end[0]), bytes(out_q[0].numpy()), bytes(out_s[0].numpy()),
           tuple(start[0].tolist()))
    assert got == (ref.score, ref.query_aligned, ref.subject_aligned,
                   tuple(ref.start))


# --- K4 / K5L, the level sweeps, on the warp strip cores at each width
# (csrc/lastcols.cu, csrc/lastcols_affine.cu) ---

_LEVEL_WIDTHS = ([("K4", w) for w in lastcols.WIDTHS]
                 + [("K5L", w) for w in lastcols.AFFINE_WIDTHS])


def _level_shapes(case, width):
    """(rows, columns) of the problems of one launch, in the orientation
    its kernel sweeps them (K4: subject rows, query columns)."""
    strip = 32 * width
    return {
        # one row, one column, fewer columns than a lane holds, exactly one
        # strip, one past a strip, and a column of one strip's rows
        "edges": [(1, 1), (1, strip + 3), (40, 1), (33, max(width - 1, 1)),
                  (45, strip), (31, strip + 1), (64, 2 * strip)],
        # rows on both sides of the 32-row chunk (odd for two rows a
        # step), problems of 1-3 strips mixed in one ticket list
        "chunks": [(31, 2 * strip + 17), (32, 5), (33, strip + 1),
                   (63, 3 * strip), (65, strip - 1), (2, 2 * strip + 1),
                   (97, strip + 40)],
        # taller than wide, and wider than tall
        "orientation": [(300, 90), (90, 300), (150, strip + 7),
                        (strip + 7, 60)],
    }[case]


def _level_case(rng, kernel, shapes):
    """A launch's (q, s, ms, ns): problem b of `shapes` in K4's transposed
    or K5L's own orientation, padded to the widest."""
    if kernel == "K4":
        ms, ns = [c for _, c in shapes], [r for r, _ in shapes]
    else:
        ms, ns = [r for r, _ in shapes], [c for _, c in shapes]
    B = len(shapes)
    q = torch.from_numpy(rng.integers(65, 69, (B, max(ms))).astype(np.uint8))
    s = torch.from_numpy(rng.integers(65, 69, (B, max(ns))).astype(np.uint8))
    return q, s, torch.tensor(ms), torch.tensor(ns)


@pytest.mark.parametrize("case", ["edges", "chunks", "orientation"])
@pytest.mark.parametrize("kernel,width", _LEVEL_WIDTHS)
def test_level_kernel_widths(emu_card, emu_lib, kernel, width, case):
    """K4 and K5L forced to each width they have against their plain
    versions, bit for bit, on problems of 1 row and of 1 column, narrower
    than a lane, one strip wide and one past, rows on both sides of the
    32-row chunk (odd ones for two rows a step), mixed strip counts in
    one ticket list, taller than wide and wider than tall; K5L with mixed
    start_gap flags at the bench scorings, a free extension and a free
    opening; every case also swept by one warp (an emulated card of 2 SMs
    x 4 CTAs)."""
    emu_card(2, 4)
    rng = np.random.default_rng(width + len(case))
    q, s, ms, ns = _level_case(rng, kernel, _level_shapes(case, width))
    for grid in (0, 1):
        if kernel == "K4":
            for sc in (SC, LinearScoring(3, -2, -2)):
                got = lastcols.launch(emu_lib, q, s, ms, ns, sc, width=width,
                                      grid=grid)
                assert lastcols.last_plan.width == width
                assert torch.equal(got, lastcols.plain(q, s, ms, ns, sc)), \
                    (sc, grid)
            continue
        for sc in ASC + ASC_EDGES[1:]:
            sg = _flags(rng, len(ms))
            got = lastcols.launch_affine(emu_lib, q, s, ms, ns, sc, sg,
                                         width=width, grid=grid)
            want = lastcols.plain_affine(q, s, ms, ns, sc, sg)
            for a, b in zip(got, want, strict=True):
                assert torch.equal(a, b), (sc, grid)


def test_level_kernel_lengths_on_host(emu_lib):
    """The level sweeps take the problems' lengths as tensors on either
    device or as lists (the level drivers keep them on the host), and
    count one launch each; an empty problem (no strips) leaves zeros."""
    rng = np.random.default_rng(5)
    q, s, ms, ns = _level_case(rng, "K4", [(40, 70), (90, 30), (1, 5)])
    want = lastcols.plain(q, s, ms, ns, SC)
    before = _build.launches["lastcols"]
    for m, n in ((ms, ns), (ms.tolist(), ns.tolist()),
                 (ms.to(torch.int32).numpy(), ns.numpy())):
        assert torch.equal(lastcols.launch(emu_lib, q, s, m, n, SC), want)
        assert torch.equal(lastcols.last_cols(q, s, m, n, SC), want)
    assert _build.launches["lastcols"] - before == 3
    got_h, got_e = lastcols.launch_affine(emu_lib, q, s, [0, 3, 1],
                                          [5, 0, 1], ASC[0],
                                          torch.zeros(3, dtype=torch.bool))
    assert got_h[:2].eq(0).all() and got_e[:2].eq(0).all()
    assert lastcols.last_plan.strips == 1


def test_level_kernel_refuses_other_widths(emu_lib):
    """A width K4 or K5L does not have (K4 has no 4 columns a lane, K5L no
    32): the launch is refused, and the wrapper raises."""
    q, s, ms, ns = _level_case(np.random.default_rng(0), "K4", [(10, 10)])
    for width in (12, 4):
        with pytest.raises(RuntimeError, match="launch failed"):
            lastcols.launch(emu_lib, q, s, ms, ns, SC, width=width)
    with pytest.raises(RuntimeError, match="launch failed"):
        lastcols.launch_affine(emu_lib, q, s, ms, ns, ASC[0],
                               torch.zeros(1, dtype=torch.bool), width=32)


def _halves(parts: int, m: int, n: int):
    """The (ms, ns) of a level of `parts` parts of an m x n alignment: each
    part's two halves, m / parts rows of n / (2 parts) columns."""
    h, w = m // parts, n // (2 * parts)
    return (np.full(2 * parts, h, np.int32), np.full(2 * parts, w, np.int32))


def _rule(lib, kernel, ms, ns, cap):
    name = "anyseq_lastcols" + ("_affine" if kernel == "K5L" else "")
    args = (ms.ctypes.data, ns.ctypes.data, len(ms))
    width = getattr(lib, name + "_width")(*args, cap)
    return width, getattr(lib, name + "_grid")(*args, width, 0)


def _scratch(kernel, ms, ns, width):
    """The bytes of boundary columns a launch at `width` holds."""
    rows, cols = (ns, ms) if kernel == "K4" else (ms, ns)
    strips = -(-cols.astype(np.int64) // (32 * width))
    return int(((strips - 1) * rows).sum()) * (8 if kernel == "K5L" else 4)


@pytest.mark.parametrize("kernel,parts,m,n,cap_gb,want", [
    # the 100k semiglobal alignments' levels 2, 5 and 8: K4 at 16 columns a
    # lane, K5L at 8 (the fastest widths measured on the card)
    ("K4", 4, 100_000, 100_000, 20, 16),
    ("K4", 32, 100_000, 100_000, 20, 16),
    ("K4", 256, 100_000, 100_000, 20, 16),
    ("K5L", 4, 100_000, 100_000, 20, 8),
    ("K5L", 32, 100_000, 100_000, 20, 8),
    ("K5L", 256, 100_000, 100_000, 20, 8),
    # the 1 Mbp alignment's levels fill the card: K4 at 32
    ("K4", 4, 1_000_000, 1_000_000, 20, 32),
    ("K4", 64, 1_000_000, 1_000_000, 20, 32),
    # the 2.2 Mbp alignments' first batched levels: K4 at 32, K5L at 16
    # (its H and E columns take 9.4 GB there, 18.9 GB at 8 columns a lane)
    ("K4", 8, 2_200_000, 2_200_000, 20, 32),
    ("K5L", 8, 2_200_000, 2_200_000, 20, 16),
    ("K5L", 64, 2_200_000, 2_200_000, 20, 16),
    # the cap: K5L at level 2 of the 100k alignment takes 76.8 MB of H and
    # E columns at 8 columns a lane, 38.4 MB at 16; K4 19.2 MB at 16 and
    # 9.6 MB at 32; a cap nothing fits under takes the widest width
    ("K5L", 4, 100_000, 100_000, 0.05, 16),
    ("K5L", 4, 100_000, 100_000, 0.01, 16),
    ("K4", 4, 100_000, 100_000, 0.01, 32),
    ("K4", 8, 2_200_000, 2_200_000, 0, 32),
])
def test_level_width_rule(emu_card, emu_lib, kernel, parts, m, n, cap_gb,
                          want):
    """anyseq_lastcols_width and anyseq_lastcols_affine_width (band_sweep.cuh
    level_width) on an emulated H100 (132 SMs x 4 CTAs): the width of least
    modelled time at the levels of the 100k, 1 Mbp and 2.2 Mbp alignments,
    among those whose boundary columns fit the cap (else the widest); the
    chosen width's columns never pass the cap where a width fits, and the
    grid reported is at most the card's resident warps."""
    emu_card(132, 4)
    ms, ns = _halves(parts, m, n)
    cap = int(cap_gb * 10**9)
    width, grid = _rule(emu_lib, kernel, ms, ns, cap)
    assert width == want
    widths = lastcols.WIDTHS if kernel == "K4" else lastcols.AFFINE_WIDTHS
    if any(_scratch(kernel, ms, ns, w) <= cap for w in widths):
        assert _scratch(kernel, ms, ns, width) <= cap
    else:
        assert width == widths[0]
    assert 1 <= grid <= 132 * 4 * 4


@pytest.mark.parametrize("affine,preds,B,m,n,cap_gb,want", [
    # the batch calls' launches (tools/k7_probe.py --sweep): ~256 bp pairs
    # in one strip of 8 columns a lane; the (256, 512) bucket's 257 to 270
    # columns in one strip of 12 (codes: 16); 4,096 bp at 8 (linear)
    (False, False, 5624, 256, (256, 256), 20, 8),
    (True, False, 5624, 256, (256, 256), 20, 8),
    (False, True, 4096, 256, (256, 256), 20, 8),
    (False, False, 4376, 256, (257, 270), 20, 12),
    (True, False, 4376, 256, (257, 270), 20, 12),
    (False, True, 4096, 256, (257, 270), 20, 16),
    (False, False, 113, 4096, (4000, 4300), 20, 8),
    # the cap: one-strip problems need no boundary columns; where no width
    # fits, the widest
    (False, False, 5624, 256, (256, 256), 0, 8),
    (False, False, 113, 4096, (4000, 4300), 0, 32),
    (True, True, 113, 4096, (4000, 4300), 0, 16),
])
def test_swarm_width_rule(emu_card, emu_lib, affine, preds, B, m, n, cap_gb,
                          want):
    """anyseq_swarm_plan's width rule (band_sweep.cuh level_width on K7's
    step costs) on an emulated H100 (132 SMs x 4 CTAs): the widths
    measured fastest at the batch calls' launches, among K7's widths for
    the scoring and codes whose boundary columns fit the cap (else the
    widest)."""
    emu_card(132, 4)
    ms = np.full(B, m, np.int32)
    ns = np.random.default_rng(B).integers(n[0], n[1] + 1, B).astype(
        np.int32)
    width, _, _ = _swarm_plan(emu_lib, ms, ns, affine, preds, 0,
                              int(cap_gb * 10**9))
    assert width == want
    assert width in swarm.widths_of(affine, preds)


def _swarm_plan(lib, ms, ns, affine, preds, width, cap=2**62):
    """anyseq_swarm_plan of a LOCAL launch: (width, meta, plan)."""
    B = len(ms)
    meta = np.full(4 * B + 1, -7, np.int64)
    plan = np.full(4, -7, np.int64)
    width = lib.anyseq_swarm_plan(ms.ctypes.data, ns.ctypes.data, B,
                                  int(affine), 2, int(preds), width, cap,
                                  meta.ctypes.data, plan.ctypes.data)
    return width, meta, plan


@pytest.mark.parametrize("affine,preds", [(False, False), (False, True),
                                          (True, False), (True, True)],
                         ids=["linear", "codes", "affine", "affine-codes"])
def test_swarm_plan_strip_list(emu_card, emu_lib, affine, preds):
    """anyseq_swarm_plan's strip list (band_sweep.cuh LevelMeta) at each of
    K7's widths and at the rule's, held to one written out here: each
    problem cut by its own length, its boundary columns after the earlier
    problems'; the strips, boundary values and warps it reports, and the
    most boundary bytes of any width (swarm.boundary_bytes) where the rule
    ran."""
    emu_card(132, 4)
    rng = np.random.default_rng(31 + 2 * affine + preds)
    ms = rng.integers(1, 700, 57).astype(np.int32)
    ns = rng.integers(1, 1500, 57).astype(np.int32)
    for w in (0, *swarm.widths_of(affine, preds)):
        width, meta, plan = _swarm_plan(emu_lib, ms, ns, affine, preds, w)
        assert width == w or (w == 0 and width in swarm.widths_of(affine,
                                                                  preds))
        strips = -(-ns.astype(np.int64) // (32 * width))
        start = np.concatenate([[0], np.cumsum(strips)])
        values = (strips - 1) * ms
        want = np.concatenate([ms, ns, start, np.cumsum(values) - values])
        np.testing.assert_array_equal(meta, want)
        assert plan[0] == start[-1] and plan[1] == values.sum()
        assert 1 <= plan[2] <= plan[0]
        assert plan[3] == (swarm.boundary_bytes(ms, ns, affine, preds)
                           if w == 0 else 0)


def test_swarm_kernel_refuses_other_widths(emu_lib):
    """A width K7 does not have (with codes no 12 columns a lane, linear no
    4): the plan refuses it, and the wrapper raises."""
    q = _seq(np.random.default_rng(0), 10)[None]
    one = np.ones(1, np.int32) * 10
    for width, sc, preds in ((12, SC, True), (4, SC, False),
                             (32, ASC[0], False)):
        with pytest.raises(ValueError, match="no width"):
            swarm.launch(emu_lib, q, q, one, one, Mode.LOCAL, sc,
                         emit_preds=preds, width=width)
