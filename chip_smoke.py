#!/usr/bin/env python3
"""Drive anyseq_tpu_torch's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a non-zero exit code):

1. Device and build: the card's name, power limit and top SM clock
   (nvidia-smi), and the nvcc build of the kernels from
   ``anyseq_tpu_torch/kernels/csrc/``; beside it, the strip-sweep
   sources built once more with ``-Xptxas -v`` (each kernel's registers
   and spills), and the warp strip cores of K8/K10, K1 and K2
   (``band.cu``), of their affine modes, K5 and K5p (``band_affine.cu``)
   and of the level
   sweeps K4 and K5L (``lastcols.cu``, ``lastcols_affine.cu``), at every
   strip width, checked to spill nothing, each kernel's SASS searched for
   the DPX instructions of the chain (VIADDMNMX, VIMNMX3); the batch
   sweep K7 (``swarm.cu``) on the same cores, every width, mode and codes
   instantiation likewise; and the walks K3 and K6 (``walk.cu``,
   ``walk_affine.cu``), checked to spill nothing.
2. Each kernel against its plain torch version on the card, on the same
   tensors, bit for bit (integer DP: the tolerance is zero), with both
   times: linear scoring 2/-1/-1 and affine scoring 2/-1/-3/-1. K1 and
   K5 also forced to each strip width they have (3 modes, K5's
   start_gap), and at ragged edges (one column, fewer than a lane holds,
   one past a strip, one row; ge = 0 and go = 0). K2 and K5p (codes)
   forced to each width they have at ~2000 x 3000 in 3 modes, each
   walked by K3 / K6, on LOCAL ties (a run over three strips, planted
   equal maxima) and at the same ragged edges and affine column-0
   scorings (``phase2_code_sweeps``, a generator of its own). K4 and
   K5L forced to each width they have on ragged levels (problems of one
   row and of one column, narrower than a lane, a strip wide and one
   past, rows on both sides of the 32-row chunk, odd rows, mixed strip
   counts, taller and wider than tall; K5L with mixed start_gap flags,
   ge = 0 and go = 0).
   K10 and K10 affine (the collective sweep) over 2 and 4 ranks of cuda:0, and
   over every card where there are several: two chained bands in 3
   modes and under start_gap, and a subject that leaves the last rank
   without columns; K7's affine codes at 4,096 problems. K8 and K10
   (and their affine modes) also with 1, 7 and strips - 1 warps beside
   the grid they choose; K8 from a boundary a little above SCORE_MIN,
   K8 affine from one on both sides of NEG (ge = 0, go = 0). K3 and K6
   across their windows: a ~2000 x 3000 full traceback whose walk runs
   a gap of 1,300 columns and one of 300 rows (3 modes), a GLOBAL walk
   along the top halo row for 1,000 columns, and 96 stripes of 1 to 512
   rows with dead walks. K7 on the warp strip cores (``phase2_swarm``, a
   generator of its own): each width forced on problems of 1, 31, 32 W -
   1, 32 W and 32 W + 1 columns by 1 to 33 rows, tall and wide ones; 256
   problems of one to twelve strips; LOCAL ties across lanes and strips;
   64 problems up to 4,500 x 4,500; 3 modes, with and without codes and
   positions, affine with mixed start-gap flags, ge = 0 and go = 0.
3. Five main paths through the public API with ``device="cuda"``, each
   driven with every launch count set to 0 just before it and read just
   after (every kernel of the path must have launched). Linear:
   ``align_score`` 1k global, ``align_full_tb`` 10k local, ``align_score``
   100k local and ``align`` 100k semiglobal (which ``traceback="auto"``
   sends to Hirschberg); affine: ``align_score`` 100k local,
   ``align_full_tb`` 10k global and ``align`` 100k semiglobal
   (Myers-Miller); each with its wall time, GCUPS and kernel launches.
   Both 100k alignments are rescored from their strings and must equal
   their score and ``align_score``. Batch: ``align_scores_batch`` and
   ``align_batch`` on 10,000 related ~256 bp pairs (local, linear and
   affine scores, linear alignments), 1,000 pairs global and semiglobal,
   and 200 pairs of ~4096 bp, each cold then warm; every alignment's
   score must equal ``align_scores_batch``'s, a sample rescores from its
   strings, the first pairs equal the plain path on the CPU, and the CLI
   (``-b ... --score-only``) prints the same scores. Small inputs (the
   golden corpus, a random pair and a small ragged batch, both schemes)
   must give the same results on the card as the plain versions on the
   CPU. Genome: ``align_score`` 1 Mbp global linear and local affine
   (chains of K8 / K8 affine bands, held to one unchained K1 / K5 sweep
   of the same pair), ``align`` 1 Mbp semiglobal linear (chained endpoint
   passes, rescored from its strings), ``ResumableScorer`` 1 Mbp global
   stopped after 5 bands and resumed in a new object (held to the first
   call; and the band-fill cost of 4,096-row against 65,536-row bands),
   ``align_hirschberg`` 100k semiglobal affine killed after its second
   checkpoint save and resumed (held to a clean run), and ``align_score``
   4.6 Mbp global linear, the E. coli-scale pair, with its peak device
   memory beside what one K1 sweep's boundary columns would take; and
   ``align`` 2.2 Mbp global, linear and affine, whose first two levels
   chain K8 (K8 affine) bands and whose 4-part level has parts taller
   than ``M_MAX`` and runs per half, each rescored from its strings.
   Mesh (every card where there are two or more, else 2 ranks of
   cuda:0): ``score_pair_sharded`` 4.6 Mbp global linear and 1 Mbp
   local affine, ``align(mesh=)`` 1 Mbp semiglobal linear (levels over
   the whole mesh and data-parallel levels) and 100k semiglobal affine,
   ``align_scores_batch_sharded`` and ``align_batch(mesh=)`` on the
   batch path's 10,000 local pairs, ``dryrun_multichip`` and
   ``score_pairs_collective`` on a 2 x 2 mesh of cuda:0 (3 pairs of
   100k, linear and affine), each equal to the single-device result of
   the same inputs. Processes (``phase3_processes``, a generator of its
   own): two worker processes (this script with ``--processes-worker``),
   each with a mesh of cuda:0, joined by ``init_distributed`` on
   127.0.0.1 over torch.distributed, run ``score_pair_sharded`` 1 Mbp
   global linear (bands of 262,144 and of 65,536 rows handed from one
   process to the other) and 100k local affine, ``align(mesh=)`` 100k
   semiglobal linear and affine (rescored from their strings) and
   ``align_batch(mesh=)`` on 10,000 local ~256 bp pairs, each cold then
   warm; both workers' results must equal each other's and the single
   device's (run first, cold then warm), and each worker must have
   launched every kernel of the path. The two processes time-slice the
   card: their walls measure the hand-off and its overhead.
4. Each kernel against its plain version again, on the very inputs the
   main paths gave it in phase 3 (kept as they passed), bit for bit; K1
   and K5 with the width and warps they ran at, bound and share, also
   alone at the largest sweep of the 100k constructions and (K5) the 100k
   local affine score; K2 and K5p at the 10k full tracebacks and, local,
   at 2,048 x 2,048 and 256 x 256, each with its width, warps, bound and
   share of its event time and of its device time (torch.profiler). K4
   and K5L at every level of the 100k
   constructions and at each width they have, each level with the rule's
   width, warps, boundary scratch, critical path, bound and share. Every
   K4 / K5L launch of phase 3 must have kept its boundary columns within
   the level rule's cap. Each whole 1 Mbp band (linear and affine) against
   the same band run as a chain of CUT_ROWS-row bands; each rank's first
   band of the mesh scores alone, and cut to CUT_ROWS rows against the
   plain version.
   K8 alone on one 262,144-row band at 1,000,000 and 4,600,000 columns,
   and K8 affine at 1,000,000, 3 runs each: median, spread, grid and
   share of its bound. K3 and K6 at the 10k full tracebacks, the ~2000 x
   3000 walks of phase 2, the largest stripe chunk of the 100k ``align``
   and (K3) the largest chunk of ``align_batch``, each with its bound,
   the bound's kind and the share. K7 at the batch calls' launches (both
   buckets of the 10k local score, the largest chunk of the 10k local
   ``align_batch``, of the affine score and of the 1k semiglobal
   ``align_batch``, the 4,096 bp launch), each with its width, warps,
   strips, boundary scratch, bound and share.
5. A JSON line of the kernels (with each one's bound: the larger of the
   bytes it must move over 3.35 TB/s and its int32 operations over 132
   SMs x 64 int32 lanes x the top SM clock; a walk's also no less than
   its longest walk's steps, one dependent shared load each), the card's
   line, and the final JSON line.

Exits with code 2 and prints no result without a CUDA device, or when
run outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 2024
ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = {
    # name: (source, the TPU kernel it replaces, the main paths that run it)
    # K1 / K2 and K5 / K5p run on the warp strip cores of K8 and K8 affine
    "wavefront_score": ("anyseq_tpu_torch/kernels/csrc/band.cu",
                        "anyseq_tpu/kernels/band.py:1336", "linear genome"),
    "wavefront_preds": ("anyseq_tpu_torch/kernels/csrc/band.cu",
                        "anyseq_tpu/kernels/band.py:1336", "linear"),
    "walk": ("anyseq_tpu_torch/kernels/csrc/walk.cu",
             "anyseq_tpu/engine/device_tb.py:405",
             "linear batch genome mesh processes"),
    "lastcols": ("anyseq_tpu_torch/kernels/csrc/lastcols.cu",
                 "anyseq_tpu/kernels/band.py:1677",
                 "linear genome mesh processes"),
    "wavefront_affine_score": (
        "anyseq_tpu_torch/kernels/csrc/band_affine.cu",
        "anyseq_tpu/kernels/band.py:1336", "affine genome"),
    "wavefront_affine_preds": (
        "anyseq_tpu_torch/kernels/csrc/band_affine.cu",
        "anyseq_tpu/kernels/band.py:1336", "affine"),
    "lastcols_affine": ("anyseq_tpu_torch/kernels/csrc/lastcols_affine.cu",
                        "anyseq_tpu/kernels/band.py:1677",
                        "affine genome mesh processes"),
    "walk_affine": ("anyseq_tpu_torch/kernels/csrc/walk_affine.cu",
                    "anyseq_tpu/engine/device_tb.py:352",
                    "affine genome mesh processes"),
    "swarm_score": ("anyseq_tpu_torch/kernels/csrc/swarm.cu",
                    "anyseq_tpu/kernels/swarm.py:318", "batch mesh"),
    "swarm_preds": ("anyseq_tpu_torch/kernels/csrc/swarm.cu",
                    "anyseq_tpu/kernels/swarm.py:318",
                    "linear batch genome mesh processes"),
    "band": ("anyseq_tpu_torch/kernels/csrc/band.cu",
             "anyseq_tpu/kernels/band.py:1443", "genome"),
    "band_affine": ("anyseq_tpu_torch/kernels/csrc/band_affine.cu",
                    "anyseq_tpu/kernels/band.py:1443", "genome"),
    # T4's collective mode (collective_axis=), reached from
    # anyseq_tpu/dist/collective.py:213 (_stripe_bands)
    "band_collective": ("anyseq_tpu_torch/kernels/csrc/band.cu",
                        "anyseq_tpu/kernels/band.py:1443",
                        "mesh processes"),
    "band_collective_affine": (
        "anyseq_tpu_torch/kernels/csrc/band_affine.cu",
        "anyseq_tpu/kernels/band.py:1443", "mesh processes"),
}
# int32 instructions a cell (or a walk step) of each kernel's function on
# an H100, a max-plus (DPX VIADDMNMX, one instruction) counted as one:
# linear H = max(max(up, left) + gap, diag + sub), sub a compare and a
# select (5); Gotoh F = max(H_up + go + ge, F_up + ge) (an add and a
# max-plus), T = max(diag + sub, F) (a max-plus beside sub's two), E's one
# max-plus along the row (its T form, carried as E - go - ge) and H =
# max(T, E) (7); LOCAL adds the running best, a three-input max for two
# cells (0.5). The plain recurrences take 6 and 11, the counts of the
# bounds before the warp cores. 2-bit codes add three compares, a shift
# and an or (5), 4-bit codes nine; a walk step decodes its code (shift,
# and), takes three compares and two decrements and forms its address (8).
OPS = {"linear": 5, "affine": 7, "best": 0.5, "codes": 5, "codes4": 9,
       "walk": 8}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT32_LANES_PER_SM = 64
# the shortest dependent step a walk can make: a shared load whose address
# hangs on the load before (tools/step_probe.py, H100 at 700 W)
SHARED_LOAD_CYCLES = 34.0
# the affine scoring of the JAX package's bench suite (bench/suite.py)
AFFINE = (2, -1, -3, -1)
# the genome path: the JAX bench suite's genome rows (1 Mbp,
# bench/suite.py:304-324) and the BASELINE north star, E. coli x S.
# boydii (~4.6 Mbp each, BASELINE.md)
GENOME_BP = 1_000_000
ECOLI_BP = 4_600_000
CKPT_BP = 100_000
RESUME_BAND_ROWS = 65_536
FILL_BAND_ROWS = 4_096           # ResumableScorer's default band
BAND_ROWS = 2_000                # phase 2's bands
BAND_BP = 40_000
COLL_ROWS = 700                  # phase 2's collective bands
COLL_BP = 30_000
CUT_ROWS = 2_048                 # phase 4's cut of a genome band
SWARM_LARGE_BP = 4_500           # phase 2's largest K7 problems
# the 4.6 Mbp global score of the seeded pair (SEED), as every run of this
# script has given it since the genome path was added
ECOLI_SCORE = 7_807_881
# the kernels whose core was redesigned for the H100: the warp strip cores
REDESIGNED = {"wavefront_score": "csrc/band_sweep.cuh",
              "wavefront_preds": "csrc/band_sweep.cuh",
              "wavefront_affine_score": "csrc/band_sweep_affine.cuh",
              "wavefront_affine_preds": "csrc/band_sweep_affine.cuh",
              "band": "csrc/band_sweep.cuh",
              "band_collective": "csrc/band_sweep.cuh",
              "band_affine": "csrc/band_sweep_affine.cuh",
              "band_collective_affine": "csrc/band_sweep_affine.cuh",
              "lastcols": "csrc/band_sweep.cuh",
              "lastcols_affine": "csrc/band_sweep_affine.cuh",
              "swarm_score": "csrc/band_sweep.cuh",
              "swarm_preds": "csrc/band_sweep.cuh",
              "walk": "csrc/walk_core.cuh",
              "walk_affine": "csrc/walk_core.cuh"}
# a linear construction long enough that its 4-part level has parts
# taller than kernels.band.M_MAX (~m / 4 > 512 Ki rows)
HB_GENOME_BP = 2_200_000
DEVICE = "cuda"
GENOME_WALLS: dict = {}          # phase 3's genome calls: wall in s
MESH_WALLS: dict = {}            # phase 3's mesh calls: wall in s
MESH_2D_BP = 100_000             # the pairs of the 2 x 2 collective batch
# single-device results that the mesh path must equal, by name
SINGLE: dict = {}
# (public call, kernel, lastcols.Plan) of every K4 / K5L launch of phase 3
LEVEL_PLANS: list = []
# (kernel, tag, shape, launch arguments) of phase 2's ~2000 x 3000 walks,
# timed with their bounds in phase 4
WALK_SHAPES: list = []


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def related_pair(rng, n: int, sub_rate=0.1, indel_rate=0.05):
    """A random DNA sequence of length n and a mutated copy (substitutions,
    insertions and deletions), as bytes."""
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    q = alphabet[rng.integers(0, 4, n)]
    s = q.copy()
    sub = rng.random(n) < sub_rate
    s[sub] = alphabet[rng.integers(0, 4, int(sub.sum()))]
    r = rng.random(n)
    dele = r < indel_rate / 2
    ins = (r >= indel_rate / 2) & (r < indel_rate)
    both = np.stack([np.where(ins, alphabet[rng.integers(0, 4, n)], 0),
                     np.where(dele, 0, s)], 1).ravel()
    return q.tobytes(), both[both != 0].tobytes()


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device time of fn() in ms over `reps` runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int = 5):
    """The median device time in ms of the kernel whose name holds
    `kernel` over `reps` runs of fn() under torch.profiler, after one
    warm-up; None where three profiles in a row missed one of its runs
    (a profile now and then catches no kernel)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        runs = [(e.time_range.end - e.time_range.start) / 1e3
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.name]
        if len(runs) == reps:
            return float(np.median(runs))
    return None


def timed(fn):
    """fn() once, and its device time in ms. No warm-up: the plain
    versions run for seconds to a minute at the main path's shapes."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(a, b) -> int:
    """Largest difference between two outputs (tensors, or dicts or tuples
    of them); a difference in keys or shapes fails the run."""
    if isinstance(a, dict):
        check(a.keys() == b.keys(), f"output keys {a.keys()} == {b.keys()}")
        return max(max_abs_err(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b, strict=True))
    check(a.shape == b.shape, f"output shape {a.shape} == {b.shape}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def compare(label, kernel, plain, reps=5):
    """The kernel's output against the plain version's, bit for bit, and
    both times. Returns (max_abs_err, kernel_ms, plain_ms)."""
    a = kernel()
    b, plain_ms = timed(plain)
    err = max_abs_err(a, b)
    check(err == 0, f"{label}: kernel == plain (max_abs_err {err})")
    ms = cuda_ms(kernel, reps)
    print(f"{label} equal=True kernel_ms={ms:.3f} plain_ms={plain_ms:.1f}",
          flush=True)
    return err, ms, plain_ms


def rescore(aln, sc) -> int:
    """The score of an alignment's strings. Affine: each maximal run of
    gaps in one sequence pays gap_open once; a gap in the other sequence
    right after it starts a new run (in this Gotoh form E opens from T,
    which includes F, and F from H, which includes E)."""
    affine = hasattr(sc, "gap_open")
    total, run = 0, None
    for cq, cs in zip(*aln.compact()):
        side = "q" if cq == "_" else "s" if cs == "_" else None
        if side is None:
            total += sc.match if cq == cs else sc.mismatch
        elif affine:
            total += sc.gap_extend + (0 if side == run else sc.gap_open)
        else:
            total += sc.gap
        run = side
    return total


def random_batch(rng, dev, B, M, N, lo=1):
    """B random problems of up to M x N symbols and their lengths."""
    q3 = torch.from_numpy(rng.integers(65, 69, (B, M), dtype=np.uint8))
    s3 = torch.from_numpy(rng.integers(65, 69, (B, N), dtype=np.uint8))
    ms_ = torch.from_numpy(rng.integers(lo, M + 1, B))
    ns_ = torch.from_numpy(rng.integers(lo, N + 1, B))
    return q3.to(dev), s3.to(dev), ms_.to(dev), ns_.to(dev)


def phase2(rng, errors):
    """Each kernel's wrapper on CUDA tensors against its plain version."""
    from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
    from anyseq_tpu_torch.engine import batch, linmem
    from anyseq_tpu_torch.kernels import _build, lastcols, swarm, walk, \
        wavefront

    sc = LinearScoring()
    dev = torch.device("cuda")

    def dev_u8(b):
        return torch.frombuffer(bytearray(b), dtype=torch.uint8).to(dev)

    def record(name, err):
        errors[name] = max(errors.get(name, 0), err)

    # K1: 3 modes at a ragged 3000 x 5000
    qb, sb = related_pair(rng, 3000)
    q, s = dev_u8(qb), dev_u8(sb + related_pair(rng, 5000 - len(sb))[0])
    for mode in (Mode.LOCAL, Mode.GLOBAL, Mode.SEMIGLOBAL):
        err, _, _ = compare(
            f"phase2 K1 wavefront_score {mode.value} {q.numel()}x{s.numel()}",
            lambda: wavefront.score(q, s, mode, sc),
            lambda: wavefront.plain(q, s, mode, sc))
        record("wavefront_score", err)

    # K2 + K3: full traceback, 3 modes at about 2000 x 3000
    qb, sb = related_pair(rng, 2000)
    q, s = dev_u8(qb), dev_u8(sb + related_pair(rng, 3000 - len(sb))[0])
    m, n = q.numel(), s.numel()
    for mode in (Mode.LOCAL, Mode.GLOBAL, Mode.SEMIGLOBAL):
        err, _, _ = compare(
            f"phase2 K2 wavefront_preds {mode.value} {m}x{n}",
            lambda: wavefront.score(q, s, mode, sc, emit_preds=True),
            lambda: wavefront.plain_preds(q, s, mode, sc))
        record("wavefront_preds", err)
        outs = wavefront.score(q, s, mode, sc, emit_preds=True)
        end = linmem.extract_end(outs, m, n, mode)[None, 1:]
        args = (outs["preds"][None], q[None], s[None], end, mode)
        err, _, _ = compare(f"phase2 K3 walk {mode.value} 1 problem {m}x{n}",
                            lambda: walk.walk(*args),
                            lambda: walk.plain(*args))
        record("walk", err)
        WALK_SHAPES.append(("walk", "K3", f"{mode.value} {m}x{n}",
                            (_build.library(), *args)))

    # K4: a ragged batch of 64 halves
    B, M, N = 64, 1500, 3000
    q3, s3, ms_, ns_ = random_batch(rng, dev, B, M, N, lo=100)
    err, _, _ = compare(f"phase2 K4 lastcols {B} halves up to {M}x{N}",
                        lambda: lastcols.last_cols(q3, s3, ms_, ns_, sc),
                        lambda: lastcols.plain(q3, s3, ms_, ns_, sc))
    record("lastcols", err)

    # K3 batched: 64 terminal stripes
    B, M, N = 64, 256, 256
    q3, s3, ms_, ns_ = random_batch(rng, dev, B, M, N)
    words, _ = batch.preds_batch(q3, s3, ms_, ns_, sc)
    ends = (torch.stack([ms_, ns_], 1) - 1).to(torch.int32)
    args = (words, q3, s3, ends, Mode.GLOBAL)
    err, _, _ = compare(f"phase2 K3 walk {B} stripes up to {M}x{N}",
                        lambda: walk.walk(*args), lambda: walk.plain(*args))
    record("walk", err)

    asc = AffineScoring(*AFFINE)
    # K5: 3 modes at a ragged 3000 x 5000, and the Myers-Miller half sweep
    # (GLOBAL, start_gap, E last column)
    qb, sb = related_pair(rng, 3000)
    q, s = dev_u8(qb), dev_u8(sb + related_pair(rng, 5000 - len(sb))[0])
    for mode, sg in ((Mode.LOCAL, False), (Mode.GLOBAL, False),
                     (Mode.SEMIGLOBAL, False), (Mode.GLOBAL, True)):
        err, _, _ = compare(
            f"phase2 K5 wavefront_affine_score {mode.value} start_gap={sg} "
            f"{q.numel()}x{s.numel()}",
            lambda: wavefront.score(q, s, mode, asc, start_gap=sg,
                                    emit_col_e=True),
            lambda: wavefront.plain_affine(q, s, mode, asc, sg, True))
        record("wavefront_affine_score", err)

    # K5p + K6: affine full traceback, 3 modes at about 2000 x 3000
    qb, sb = related_pair(rng, 2000)
    q, s = dev_u8(qb), dev_u8(sb + related_pair(rng, 3000 - len(sb))[0])
    m, n = q.numel(), s.numel()
    for mode in (Mode.LOCAL, Mode.GLOBAL, Mode.SEMIGLOBAL):
        err, _, _ = compare(
            f"phase2 K5p wavefront_affine_preds {mode.value} {m}x{n}",
            lambda: wavefront.score(q, s, mode, asc, emit_preds=True),
            lambda: wavefront.plain_affine_preds(q, s, mode, asc))
        record("wavefront_affine_preds", err)
        outs = wavefront.score(q, s, mode, asc, emit_preds=True)
        end = linmem.extract_end(outs, m, n, mode)[None, 1:]
        no_gap = torch.zeros(1, dtype=torch.bool, device=dev)
        args = (outs["preds"][None], q[None], s[None], end, mode, no_gap,
                no_gap)
        err, _, _ = compare(
            f"phase2 K6 walk_affine {mode.value} 1 problem {m}x{n}",
            lambda: walk.walk_affine(*args), lambda: walk.plain_affine(*args))
        record("walk_affine", err)
        WALK_SHAPES.append(("walk_affine", "K6", f"{mode.value} {m}x{n}",
                            (_build.library(), *args)))

    # K5L: 64 ragged halves with mixed start-gap flags
    B, M, N = 64, 1500, 3000
    q3, s3, ms_, ns_ = random_batch(rng, dev, B, M, N, lo=100)
    sg = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    err, _, _ = compare(
        f"phase2 K5L lastcols_affine {B} halves up to {M}x{N}",
        lambda: lastcols.last_cols_affine(q3, s3, ms_, ns_, asc, sg),
        lambda: lastcols.plain_affine(q3, s3, ms_, ns_, asc, sg))
    record("lastcols_affine", err)

    # K6 batched: 64 terminal stripes with mixed start- and end-gap flags
    B, M, N = 64, 256, 256
    q3, s3, ms_, ns_ = random_batch(rng, dev, B, M, N)
    sg = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    eg = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    words, _, _ = batch.preds_batch_affine(q3, s3, ms_, ns_, asc, sg)
    ends = (torch.stack([ms_, ns_], 1) - 1).to(torch.int32)
    args = (words, q3, s3, ends, Mode.GLOBAL, sg, eg)
    err, _, _ = compare(f"phase2 K6 walk_affine {B} stripes up to {M}x{N}",
                        lambda: walk.walk_affine(*args),
                        lambda: walk.plain_affine(*args))
    record("walk_affine", err)

    # K7: a ragged batch of 3000 problems up to 300 x 300 (subject rows
    # not a multiple of 16 wide), 3 modes; linear with and without codes,
    # affine with mixed start-gap flags
    B, M, N = 3000, 300, 300
    q3, s3, ms_, ns_ = random_batch(rng, dev, B, M, N)
    sg = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    for mode in (Mode.LOCAL, Mode.GLOBAL, Mode.SEMIGLOBAL):
        for scoring, preds in ((sc, False), (sc, True), (asc, False)):
            flags = sg if scoring is asc else None
            args = (q3, s3, ms_, ns_, mode, scoring, flags, True, preds)
            name = "swarm_preds" if preds else "swarm_score"
            err, _, _ = compare(
                f"phase2 K7 {name} {mode.value} {type(scoring).__name__} "
                f"{B} problems up to {M}x{N}",
                lambda: swarm.score_pairs_swarm(*args),
                lambda: swarm.plain(*args))
            record(name, err)


def longest_runs(out_q, out_s) -> tuple:
    """(columns, rows): the longest run of gaps in the query (a horizontal
    run of the walk) and in the subject (a vertical run), over a walk's
    live positions."""
    runs = []
    for row in (out_q, out_s):
        seq = row[row != ord(" ")].cpu().numpy() == ord("_")
        edges = np.flatnonzero(np.diff(np.r_[0, seq.astype(np.int8), 0]))
        runs.append(int((edges[1::2] - edges[::2]).max()) if len(edges)
                    else 0)
    return tuple(runs)


def phase2_walks(rng, errors):
    """K3 and K6 across their windows (``csrc/walk_core.cuh``: 96 rows of
    112 columns, the next loaded 32 steps ahead) against their plain
    versions, bit for bit: a ~2000 x 3000 pair whose full traceback walks
    a horizontal gap run longer than two windows' widths and a vertical
    one longer than two windows' heights (3 modes; checked on the GLOBAL
    walk's strings); a GLOBAL walk that reaches the top halo row 1000
    columns from column 0; 96 stripes of mixed heights (1 to 512 rows)
    with dead walks and, affine, mixed start- and end-gap flags."""
    from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
    from anyseq_tpu_torch.engine import batch, linmem
    from anyseq_tpu_torch.kernels import _build, walk, wavefront

    dev = torch.device("cuda")
    alphabet = np.frombuffer(b"ACGT", np.uint8)

    def dna(n):
        return torch.from_numpy(alphabet[rng.integers(0, 4, n)]).to(dev)

    def run_of(byte, n):
        return torch.full((n,), byte, dtype=torch.uint8, device=dev)

    # inserts of a byte that matches nothing: one run each, unbroken
    base = dna(1700)
    gap_runs = (torch.cat([base[:800], run_of(ord("X"), 300), base[800:]]),
                torch.cat([base[:300], run_of(ord("Z"), 1300), base[300:]]))
    s = dna(3000)
    cases = (("gap runs", gap_runs, list(Mode)),
             ("halo row", (s[1000:], s), [Mode.GLOBAL]))
    no_gap = torch.zeros(1, dtype=torch.bool, device=dev)
    for scoring in (LinearScoring(), AffineScoring(*AFFINE)):
        affine = isinstance(scoring, AffineScoring)
        name, tag = ("walk_affine", "K6") if affine else ("walk", "K3")
        fn = walk.walk_affine if affine else walk.walk
        plain = walk.plain_affine if affine else walk.plain
        for label, (q, s), modes in cases:
            m, n = q.numel(), s.numel()
            for mode in modes:
                outs = wavefront.score(q, s, mode, scoring, emit_preds=True)
                end = linmem.extract_end(outs, m, n, mode)[None, 1:]
                args = (outs["preds"][None], q[None], s[None], end, mode)
                args += (no_gap, no_gap) if affine else ()
                err, _, _ = compare(
                    f"phase2 {tag} {name} {label} {mode.value} {m}x{n}",
                    lambda: fn(*args), lambda: plain(*args))
                errors[name] = max(errors.get(name, 0), err)
                WALK_SHAPES.append((name, tag, f"{label} {mode.value} "
                                               f"{m}x{n}",
                                    (_build.library(), *args)))
                out_q, out_s, start = fn(*args)
                if label == "gap runs" and mode is Mode.GLOBAL:
                    cols, rows = longest_runs(out_q[0], out_s[0])
                    check(cols > 2 * 112 and rows > 2 * 96,
                          f"{tag} {label}: runs of {cols} columns and "
                          f"{rows} rows cross two windows")
                    print(f"phase2 {tag} {label}: longest runs {cols} "
                          f"columns, {rows} rows", flush=True)
                if label == "halo row":
                    check(start.tolist() == [[0, 0]] and bool(
                        (out_q[0, :1000] == ord("_")).all()),
                          f"{tag} {label}: the walk runs along row -1")
        # 96 stripes of mixed heights, every fifth walk dead
        B, M, N = 96, 512, 256
        q3, s3, ms_, ns_ = random_batch(rng, dev, B, M, N)
        sg = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
        eg = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
        if affine:
            words = batch.preds_batch_affine(q3, s3, ms_, ns_, scoring,
                                             sg)[0]
        else:
            words = batch.preds_batch(q3, s3, ms_, ns_, scoring)[0]
        ends = (torch.stack([ms_, ns_], 1) - 1).to(torch.int32)
        ends[::5] = -1
        args = (words, q3, s3, ends, Mode.GLOBAL)
        args += (sg, eg) if affine else ()
        err, _, _ = compare(f"phase2 {tag} {name} {B} stripes of 1 to {M} "
                            f"rows up to {N} columns, {len(ends[::5])} dead",
                            lambda: fn(*args), lambda: plain(*args))
        errors[name] = max(errors.get(name, 0), err)


def sweep_geometry(affine: bool, m: int, n: int, mode, width: int = 0,
                   codes: bool = False):
    """(width, grid) of a K1 / K5 (`codes`: K2 / K5p) launch on m x n in
    `mode`: the columns a lane its width rule chooses on this card (or
    `width`), and the warps it then launches."""
    from anyseq_tpu_torch.kernels import _build

    lib = _build.library()
    pre = "anyseq_sweep_affine" if affine else "anyseq_sweep"
    width = width or getattr(lib, pre + "_width")(m, n, band_mode(mode),
                                                  int(codes))
    return width, getattr(lib, pre + "_grid")(m, n, band_mode(mode), width,
                                              int(codes))


def phase2_sweeps(errors):
    """K1 and K5, the score sweeps on the warp strip cores, forced to each
    width they have against their plain versions, bit for bit: 3 modes
    (and K5's Myers-Miller start_gap, always with the E column) at a
    ragged 3000 x 5000; then the ragged edges in LOCAL and GLOBAL (one
    column, fewer columns than a lane holds, one past a strip, one row),
    and scorings with ge = 0 and go = 0 at the affine column 0. The pair
    comes from a generator of its own, so that the main paths' pairs stay
    those of every earlier run."""
    from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
    from anyseq_tpu_torch.kernels import _build, band, wavefront

    rng = np.random.default_rng(SEED + 2)
    dev = torch.device(DEVICE)
    lib = _build.library()
    sc, asc = LinearScoring(), AffineScoring(*AFFINE)

    def dev_u8(b):
        return torch.frombuffer(bytearray(b), dtype=torch.uint8).to(dev)

    def sweep(q, s, mode, scoring, sg, width):
        if isinstance(scoring, AffineScoring):
            return wavefront.launch_affine(lib, q, s, mode, scoring, False,
                                           sg, True, width=width)
        return wavefront.launch(lib, q, s, mode, scoring, False, width=width)

    def plain(q, s, mode, scoring, sg):
        if isinstance(scoring, AffineScoring):
            return wavefront.plain_affine(q, s, mode, scoring, sg, True)
        return wavefront.plain(q, s, mode, scoring)

    def held(tag, q, s, mode, scoring, sg, reps):
        affine = isinstance(scoring, AffineScoring)
        name = "wavefront_affine_score" if affine else "wavefront_score"
        want, plain_ms = timed(lambda: plain(q, s, mode, scoring, sg))
        m, n = q.numel(), s.numel()
        rule = sweep_geometry(affine, m, n, mode)[0]
        out = []
        for w in band.AFFINE_WIDTHS if affine else band.WIDTHS:
            err = max_abs_err(sweep(q, s, mode, scoring, sg, w), want)
            check(err == 0, f"{tag} {m}x{n} width {w}: kernel == plain "
                            f"(max_abs_err {err})")
            errors[name] = max(errors.get(name, 0), err)
            if reps:
                ms = cuda_ms(lambda: sweep(q, s, mode, scoring, sg, w), reps)
                out.append(f"{w}: {ms:.3f} ms, "
                           f"{sweep_geometry(affine, m, n, mode, w)[1]} warps")
            else:
                out.append(str(w))
        print(f"{tag} {m}x{n} equal=True at widths {'; '.join(out)} "
              f"(rule: {rule}) plain_ms={plain_ms:.1f}", flush=True)

    qb, sb = related_pair(rng, 3000)
    q, s = dev_u8(qb), dev_u8(sb + related_pair(rng, 5000 - len(sb))[0])
    for scoring, mode, sg in (
            [(sc, mode, False) for mode in Mode]
            + [(asc, mode, False) for mode in Mode]
            + [(asc, Mode.GLOBAL, True)]):
        kname = "K5" if scoring is asc else "K1"
        held(f"phase2 {kname} {mode.value} start_gap={sg}", q, s, mode,
             scoring, sg, reps=3)
    # ragged edges, and the affine chain's edges at column 0
    edges = sorted({1, 3, 37} | {32 * w + 1 for w in
                                 band.WIDTHS + band.AFFINE_WIDTHS})
    for scoring in (sc, asc, AffineScoring(1, -6, -4, 0),
                    AffineScoring(2, -1, 0, -1)):
        kname = "K1" if scoring is sc else "K5"
        for mode in (Mode.LOCAL, Mode.GLOBAL):
            for m, n in [(40, w) for w in edges] + [(1, 300), (70, 1)]:
                for sg in ([False, True] if scoring is not sc
                           and mode is Mode.GLOBAL else [False]):
                    held(f"phase2 {kname} edge {scoring} {mode.value} "
                         f"start_gap={sg}", q[:m], s[:n], mode, scoring, sg,
                         reps=0)


def phase2_code_sweeps(errors):
    """K2 and K5p, the sweeps with codes on the warp strip cores' OUT_CODES
    mode, forced to each width they have against their plain versions,
    bit for bit (codes, last row and column, best; K5p also the E last
    column): 3 modes at ~2000 x 3000, each walked by K3 / K6 from its end
    cell against the plain walk; LOCAL ties (a run of one symbol, whose
    maximum fills a whole row over three strips, and equal planted maxima
    on one row in two strips after an earlier-column one on a later row);
    ragged edges and, K5p, scorings with ge = 0 and go = 0, whose PE bit
    of column 0 comes from E[i][-1] = NEG + go - ge. A generator of its
    own, so that the main paths' pairs stay those of every earlier run."""
    from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
    from anyseq_tpu_torch.engine import linmem
    from anyseq_tpu_torch.kernels import _build, band, walk, wavefront

    rng = np.random.default_rng(SEED + 12)
    dev = torch.device(DEVICE)
    lib = _build.library()
    sc, asc = LinearScoring(), AffineScoring(*AFFINE)

    def dev_u8(b):
        return torch.frombuffer(bytearray(b), dtype=torch.uint8).to(dev)

    def sweep(q, s, mode, scoring, width):
        if isinstance(scoring, AffineScoring):
            return wavefront.launch_affine(lib, q, s, mode, scoring, True,
                                           False, True, width=width)
        return wavefront.launch(lib, q, s, mode, scoring, True, width=width)

    def plain(q, s, mode, scoring):
        if isinstance(scoring, AffineScoring):
            want = wavefront.plain_affine(q, s, mode, scoring, False, True)
            want["preds"] = wavefront.plain_affine_preds(q, s, mode,
                                                         scoring)["preds"]
            return want
        return wavefront.plain_preds(q, s, mode, scoring)

    def held(tag, q, s, mode, scoring, reps, walked=False):
        affine = isinstance(scoring, AffineScoring)
        name = "wavefront_affine_preds" if affine else "wavefront_preds"
        want, plain_ms = timed(lambda: plain(q, s, mode, scoring))
        m, n = q.numel(), s.numel()
        rule = sweep_geometry(affine, m, n, mode, codes=True)[0]
        out = []
        for w in band.AFFINE_CODE_WIDTHS if affine else band.CODE_WIDTHS:
            got = sweep(q, s, mode, scoring, w)
            err = max_abs_err(got, want)
            check(err == 0, f"{tag} {m}x{n} width {w}: kernel == plain "
                            f"(max_abs_err {err})")
            errors[name] = max(errors.get(name, 0), err)
            if reps:
                ms = cuda_ms(lambda: sweep(q, s, mode, scoring, w), reps)
                out.append(f"{w}: {ms:.3f} ms, " + str(sweep_geometry(
                    affine, m, n, mode, w, codes=True)[1]) + " warps")
            else:
                out.append(str(w))
        print(f"{tag} {m}x{n} equal=True at widths {'; '.join(out)} "
              f"(rule: {rule}) plain_ms={plain_ms:.1f}", flush=True)
        if walked:
            wname, wtag = ("walk_affine", "K6") if affine else ("walk", "K3")
            end = linmem.extract_end(want, m, n, mode)[None, 1:]
            args = (want["preds"][None], q[None], s[None], end, mode)
            if affine:
                no_gap = torch.zeros(1, dtype=torch.bool, device=dev)
                args += (no_gap, no_gap)
            fn = walk.walk_affine if affine else walk.walk
            err, _, _ = compare(
                f"{tag} then {wtag} {wname} from the end cell {m}x{n}",
                lambda: fn(*args),
                lambda: (walk.plain_affine if affine else walk.plain)(*args))
            errors[wname] = max(errors.get(wname, 0), err)
        return want

    qb, sb = related_pair(rng, 2000)
    q, s = dev_u8(qb), dev_u8(sb + related_pair(rng, 3000 - len(sb))[0])
    for scoring in (sc, asc):
        kname = "K5p" if scoring is asc else "K2"
        for mode in Mode:
            held(f"phase2 {kname} {mode.value}", q, s, mode, scoring,
                 reps=3, walked=True)
    # LOCAL ties at each width's strips: the first maximum in row-major
    # order, under match 1 and -100 for a mismatch or a gap
    x, y = b"ACGTTGCAAGTC", b"TTGACCAGTGCA"
    for scoring in (LinearScoring(1, -100, -100),
                    AffineScoring(1, -100, -100, -100)):
        affine = isinstance(scoring, AffineScoring)
        kname = "K5p" if affine else "K2"
        for w in band.AFFINE_CODE_WIDTHS if affine else band.CODE_WIDTHS:
            strip = 32 * w
            run = dev_u8(b"A" * 3 * strip)
            got = held(f"phase2 {kname} ties run strips of {strip}",
                       run[:50], run, Mode.LOCAL, scoring, reps=0)
            check(got["best"].tolist() == [50, 49, 49],
                  f"{kname} run: first maximum at (49, 49)")
            qp = np.frombuffer(b"AC", np.uint8)[rng.integers(0, 2, 80)]
            sp = np.frombuffer(b"GT", np.uint8)[rng.integers(0, 2,
                                                           3 * strip)]
            qp, sp = qp.copy(), sp.copy()
            for text, qi, sj in ((x, 40, 2 * strip + 30),
                                 (x, 40, strip + 30), (y, 60, 30)):
                b = np.frombuffer(text, np.uint8)
                qp[qi - len(b) + 1:qi + 1] = b
                sp[sj - len(b) + 1:sj + 1] = b
            got = held(f"phase2 {kname} ties planted strips of {strip}",
                       dev_u8(qp.tobytes()), dev_u8(sp.tobytes()),
                       Mode.LOCAL, scoring, reps=0)
            check(got["best"].tolist() == [12, 40, strip + 30],
                  f"{kname} planted: first maximum at (40, {strip + 30})")
    # ragged edges, and the affine chain's edges at column 0
    edges = sorted({1, 3, 37} | {32 * w + 1 for w in
                                 band.CODE_WIDTHS + band.AFFINE_CODE_WIDTHS})
    for scoring in (sc, asc, AffineScoring(1, -6, -4, 0),
                    AffineScoring(2, -1, 0, -1)):
        kname = "K2" if scoring is sc else "K5p"
        for mode in (Mode.LOCAL, Mode.GLOBAL):
            for m, n in [(40, w) for w in edges] + [(1, 300), (70, 1)]:
                held(f"phase2 {kname} edge {scoring} {mode.value}", q[:m],
                     s[:n], mode, scoring, reps=0)


def level_shapes(width: int):
    """Ragged levels at `width` columns a lane, as (rows, columns) of each
    problem in the orientation its kernel sweeps it: problems of one row
    and of one column, narrower than a lane, a strip wide and one past;
    rows on both sides of the 32-row chunk (odd ones), 1-3 strips mixed in
    one ticket list; taller than wide and wider than tall."""
    strip = 32 * width
    return [[(1, 1), (1, strip + 3), (40, 1), (33, max(width - 1, 1)),
             (45, strip), (31, strip + 1), (64, 2 * strip)],
            [(31, 2 * strip + 17), (32, 5), (33, strip + 1),
             (63, 3 * strip), (65, strip - 1), (2, 2 * strip + 1),
             (97, strip + 40)],
            [(300, 90), (90, 300), (150, strip + 7), (strip + 7, 60)]]


def level_path_steps(affine: bool, ms, ns, width: int) -> int:
    """The critical path of a K4 (K5L) launch at `width` columns a lane,
    in steps: the slowest problem's (steps + 31) + (strips - 1) x lag, a
    step one row (K5L below 16 columns a lane two), strips lag = 32 /
    rows + 31 steps apart (csrc/band_sweep.cuh level_width)."""
    ms, ns = (torch.as_tensor(x).cpu().to(torch.int64) for x in (ms, ns))
    rows, cols = (ms, ns) if affine else (ns, ms)
    per = 2 if affine and width < 16 else 1
    strips = torch.where((rows > 0) & (cols > 0),
                         -(-cols // (32 * width)), 0)
    path = -(-rows // per) + 31 + (strips - 1) * (32 // per + 31)
    return int(torch.where(strips > 0, path, 0).max())


def phase2_levels(errors):
    """K4 and K5L, the level sweeps on the warp strip cores, forced to each
    width they have against their plain versions, bit for bit: phase 2's
    64 ragged halves and the ragged levels of level_shapes at each width
    (K4 with two linear scorings; K5L with mixed start_gap flags at the
    bench scoring, a free extension and a free opening). The problems come
    from a generator of their own, so that the main paths' pairs stay
    those of every earlier run."""
    from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring
    from anyseq_tpu_torch.kernels import _build, lastcols

    rng = np.random.default_rng(SEED + 4)
    dev = torch.device(DEVICE)
    lib = _build.library()
    for kernel, name, widths, scorings in (
            ("K4", "lastcols", lastcols.WIDTHS,
             [LinearScoring(), LinearScoring(3, -2, -2)]),
            ("K5L", "lastcols_affine", lastcols.AFFINE_WIDTHS,
             [AffineScoring(*AFFINE), AffineScoring(1, -6, -4, 0),
              AffineScoring(2, -1, 0, -1)])):
        affine = kernel == "K5L"
        cases = [(random_batch(rng, dev, 64, 1500, 3000, lo=100),
                  scorings[:1])]
        for width in widths:
            for shapes in level_shapes(width):
                rows, cols = zip(*shapes)
                ms_, ns_ = (rows, cols) if affine else (cols, rows)
                B = len(shapes)
                q3 = torch.from_numpy(rng.integers(
                    65, 69, (B, max(ms_)), dtype=np.uint8)).to(dev)
                s3 = torch.from_numpy(rng.integers(
                    65, 69, (B, max(ns_)), dtype=np.uint8)).to(dev)
                cases.append(((q3, s3, torch.tensor(ms_), torch.tensor(ns_)),
                              scorings))
        for (q3, s3, ms_, ns_), scs in cases:
            sg = torch.from_numpy(rng.integers(0, 2, q3.shape[0])
                                  .astype(bool)).to(dev)
            for scoring in scs:
                extra = (sg,) if affine else ()
                want = getattr(lastcols, "plain_affine" if affine
                               else "plain")(q3, s3, ms_, ns_, scoring,
                                             *extra)
                for w in widths:
                    got = getattr(lastcols, "launch_affine" if affine
                                  else "launch")(lib, q3, s3, ms_, ns_,
                                                 scoring, *extra, width=w)
                    err = max_abs_err(got, want)
                    check(err == 0, f"phase2 {kernel} {name} B={len(ms_)} "
                                    f"width {w} {scoring}: kernel == plain "
                                    f"(max_abs_err {err})")
                    errors[name] = max(errors.get(name, 0), err)
            print(f"phase2 {kernel} {name} B={len(ms_)} up to "
                  f"{int(max(ms_))}x{int(max(ns_))} equal=True at widths "
                  f"{list(widths)} for {len(scs)} scorings", flush=True)


# The launch function of each kernel wrapper module (K1/K2 share one, as
# do K5/K5p); the plain version takes the same arguments after the library.
LAUNCHERS = {
    "wavefront": ("wavefront", "launch"),
    "wavefront_affine": ("wavefront", "launch_affine"),
    "walk": ("walk", "launch"),
    "walk_affine": ("walk", "launch_affine"),
    "lastcols": ("lastcols", "launch"),
    "lastcols_affine": ("lastcols", "launch_affine"),
    "swarm": ("swarm", "launch"),
    "band": ("band", "launch"),
    "band_affine": ("band", "launch_affine"),
    "band_collective": ("band", "launch_collective"),
    "band_collective_affine": ("band", "launch_collective_affine"),
}


def wrapper_module(fn: str):
    return importlib.import_module(
        f"anyseq_tpu_torch.kernels.{LAUNCHERS[fn][0]}")


def launcher(fn: str):
    return getattr(wrapper_module(fn), LAUNCHERS[fn][1])


def plain_of(fn: str, args):
    """The plain version's output on the arguments of a kept launch."""
    mod = wrapper_module(fn)
    if fn == "wavefront":
        _, q, s, mode, sc, emit_preds = args
        return (mod.plain_preds if emit_preds else mod.plain)(q, s, mode, sc)
    if fn == "wavefront_affine":
        _, q, s, mode, sc, emit_preds, start_gap, emit_col_e = args
        if emit_preds:
            return mod.plain_affine_preds(q, s, mode, sc)
        return mod.plain_affine(q, s, mode, sc, start_gap, emit_col_e)
    if fn.startswith("band_collective"):
        return getattr(mod, fn.replace("band_collective", "plain_collective")
                       )(*args[1:])
    return getattr(mod, "plain_affine" if fn.endswith("_affine")
                   else "plain")(*args[1:])


@contextlib.contextmanager
def kept_launches(kept: list, call: list):
    """Keep (call[0], launcher, arguments) of every kernel launch made
    inside the block; `call[0]` names the public call being driven. (The
    keyword arguments, K10's share of the card, are not kept: a launch
    replayed alone has the card to itself.)"""
    real = {fn: launcher(fn) for fn in LAUNCHERS}

    def keeping(fn):
        def launch(*args, **kwargs):
            kept.append((call[0], fn, args))
            out = real[fn](*args, **kwargs)
            if fn.startswith("lastcols"):
                LEVEL_PLANS.append((call[0], fn,
                                    wrapper_module(fn).last_plan))
            return out
        return launch

    for fn, (_, attr) in LAUNCHERS.items():
        setattr(wrapper_module(fn), attr, keeping(fn))
    try:
        yield
    finally:
        for fn, (_, attr) in LAUNCHERS.items():
            setattr(wrapper_module(fn), attr, real[fn])


def read_counts(path: str, counts: dict) -> None:
    """Add each launch count of the path just driven to `counts` (a kernel
    on several paths sums them); every kernel of the path must be > 0."""
    from anyseq_tpu_torch.kernels import _build

    for k, v in _build.launches.items():
        if path in KERNELS[k][2].split():
            counts[k] = counts.get(k, 0) + v
            check(v > 0, f"kernel {k} launched on the {path} main path ({v})")


def phase3(rng, kept):
    """The single-pair main path through the public API, one path per gap
    scheme, each driven with every launch count set to 0 just before it
    and read just after; returns each kernel's count from the paths that
    run it."""
    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch.kernels import _build

    sc = pt.LinearScoring()
    asc = pt.AffineScoring(*AFFINE)
    pairs = {n: related_pair(rng, n) for n in (1000, 10_000, 100_000)}
    paths = {
        "linear": (
            ("align_score", 1000, "global", sc),
            ("align_full_tb", 10_000, "local", sc),
            ("align_score", 100_000, "local", sc),
            ("align", 100_000, "semiglobal", sc),
        ),
        "affine": (
            ("align_score", 100_000, "local", asc),
            ("align_full_tb", 10_000, "global", asc),
            ("align", 100_000, "semiglobal", asc),
        ),
    }
    torch.cuda.synchronize()
    current = [None]
    results, counts = {}, {}
    with kept_launches(kept, current):
        for path, calls in paths.items():
            for k in _build.launches:
                _build.launches[k] = 0
            for name, n, mode, scoring in calls:
                q, s = pairs[n]
                scheme = type(scoring).__name__
                current[0] = (name, n, mode, scheme)
                before = dict(_build.launches)
                t0 = time.perf_counter()
                out = getattr(pt, name)(q, s, mode, scoring, device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                cells = len(q) * len(s)
                delta = {k: v - before[k] for k, v in _build.launches.items()
                         if v > before[k]}
                score = out if isinstance(out, int) else out.score
                print(f"phase3 {name} {mode} {scheme} {len(q)}x{len(s)} "
                      f"score={score} wall_s={wall:.4f} "
                      f"gcups={cells / wall / 1e9:.2f} "
                      f"launches={json.dumps(delta)}", flush=True)
                results[current[0]] = out
            read_counts(path, counts)

    q, s = pairs[100_000]
    SINGLE["align 100k semiglobal affine"] = (
        q, s, results[("align", 100_000, "semiglobal", "AffineScoring")])
    for scoring in (sc, asc):
        scheme = type(scoring).__name__
        aln = results[("align", 100_000, "semiglobal", scheme)]
        again = pt.align_score(q, s, "semiglobal", scoring, device="cuda")
        got = rescore(aln, scoring)
        check(got == aln.score == again,
              f"100k semiglobal {scheme} rescore {got} == score "
              f"{aln.score} == align_score {again}")
        print(f"phase3 100k semiglobal {scheme} rescored={got} "
              f"align_score={again} equal=True", flush=True)
    return counts


def phase3_batch(rng, kept, counts):
    """The batch path through the public API, driven with every launch
    count set to 0 just before it and read just after: each call cold,
    then warm, with its wall, GCUPS (the pairs' m * n over the wall) and
    the cold call's launches. Then: every alignment's score equals
    ``align_scores_batch``'s, 256 alignments of each call rescore from
    their strings, the first pairs of each call equal the plain path on the
    CPU, and the CLI's ``-b`` mode prints ``align_scores_batch``'s
    scores."""
    import dataclasses
    import io
    import tempfile

    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch import cli
    from anyseq_tpu_torch.kernels import _build

    sc = pt.LinearScoring()
    asc = pt.AffineScoring(*AFFINE)
    sets = {256: [related_pair(rng, 256) for _ in range(10_000)],
            4096: [related_pair(rng, 4096) for _ in range(200)]}
    calls = (
        ("align_scores_batch", 256, 10_000, "local", sc),
        ("align_scores_batch", 256, 10_000, "local", asc),
        ("align_batch", 256, 10_000, "local", sc),
        ("align_scores_batch", 256, 1000, "global", sc),
        ("align_batch", 256, 1000, "global", sc),
        ("align_scores_batch", 256, 1000, "semiglobal", sc),
        ("align_batch", 256, 1000, "semiglobal", sc),
        ("align_scores_batch", 4096, 200, "local", sc),
    )

    def pairs(n, count):
        qs, ss = zip(*sets[n][:count])
        return list(qs), list(ss)

    torch.cuda.synchronize()
    for k in _build.launches:
        _build.launches[k] = 0
    current = [None]
    results = {}
    with kept_launches(kept, current):
        for name, n, count, mode, scoring in calls:
            qs, ss = pairs(n, count)
            scheme = type(scoring).__name__
            current[0] = (name, n, count, mode, scheme)
            cells = sum(len(a) * len(b) for a, b in zip(qs, ss))
            walls = []
            for _ in ("cold", "warm"):
                before = dict(_build.launches)
                t0 = time.perf_counter()
                out = getattr(pt, name)(qs, ss, mode, scoring, device="cuda")
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if len(walls) == 1:
                    delta = {k: v - before[k]
                             for k, v in _build.launches.items()
                             if v > before[k]}
            print(f"phase3 {name} {mode} {scheme} {count} pairs ~{n} bp "
                  f"cells={cells} wall_s cold={walls[0]:.4f} "
                  f"warm={walls[1]:.4f} gcups cold="
                  f"{cells / walls[0] / 1e9:.2f} "
                  f"warm={cells / walls[1] / 1e9:.2f} "
                  f"launches={json.dumps(delta)}", flush=True)
            results[current[0]] = out

        # the CLI's batch mode, in-process, on the first 1000 local pairs
        qs, ss = pairs(256, 1000)
        current[0] = ("cli -b --score-only", 256, 1000, "local",
                      "LinearScoring")
        with tempfile.TemporaryDirectory() as tmp:
            files = []
            for name, seqs in (("q.fa", qs), ("s.fa", ss)):
                files.append(os.path.join(tmp, name))
                with open(files[-1], "wb") as f:
                    f.write(b"".join(b">%d\n%s\n" % (i, x)
                                     for i, x in enumerate(seqs)))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["-b", *files, "--mode", "local",
                               "--score-only"])
        lines = [x for x in buf.getvalue().splitlines()
                 if x.startswith("pair ")]
        want = results[("align_scores_batch", 256, 10_000, "local",
                        "LinearScoring")][:1000]
        check(rc == 0 and lines == [f"pair {i}: score {v}"
                                    for i, v in enumerate(want.tolist())],
              "CLI -b --score-only prints align_scores_batch's scores")
        print(f"phase3 cli -b --score-only local 1000 pairs: {len(lines)} "
              f"scores equal", flush=True)
    read_counts("batch", counts)
    SINGLE["batch 10k local"] = (
        *pairs(256, 10_000),
        results[("align_scores_batch", 256, 10_000, "local", "LinearScoring")],
        results[("align_batch", 256, 10_000, "local", "LinearScoring")])

    for count, mode in ((10_000, "local"), (1000, "global"),
                        (1000, "semiglobal")):
        alns = results[("align_batch", 256, count, mode, "LinearScoring")]
        scores = results[("align_scores_batch", 256, count, mode,
                          "LinearScoring")]
        check([a.score for a in alns] == scores.tolist(),
              f"align_batch {mode} scores == align_scores_batch")
        sample = rng.choice(count, 256, replace=False)
        check(all(rescore(alns[i], sc) == alns[i].score for i in sample),
              f"align_batch {mode}: 256 alignments rescore to their score")
        print(f"phase3 align_batch {mode} {count} pairs: scores == "
              f"align_scores_batch, 256 rescored equal", flush=True)
    for (name, n, count, mode, scheme), out in results.items():
        k = 16 if n == 4096 else 256
        qs, ss = pairs(n, k)
        scoring = sc if scheme == "LinearScoring" else asc
        want = getattr(pt, name)(qs, ss, mode, scoring, device="cpu")
        if name == "align_batch":
            same = ([dataclasses.astuple(a) for a in out[:k]]
                    == [dataclasses.astuple(a) for a in want])
        else:
            same = out[:k].tolist() == want.tolist()
        check(same, f"{name} {mode} {scheme}: first {k} pairs, card == CPU")
    print("phase3 batch calls: first pairs of each equal to the CPU plain "
          "path", flush=True)


def phase3_small(rng):
    """The public API on small inputs: card == plain versions on the CPU,
    and the golden corpus's scores and full-traceback strings."""
    import dataclasses

    import anyseq_tpu_torch as pt

    q, s = related_pair(rng, 700)
    for sc in (pt.LinearScoring(), pt.AffineScoring(*AFFINE)):
        for mode in ("global", "semiglobal", "local"):
            for fn in (pt.align_score, pt.align_full_tb,
                       lambda *a, **k: pt.align(*a, traceback="hirschberg",
                                                **k)):
                a = fn(q, s, mode, sc, device="cuda")
                b = fn(q, s, mode, sc, device="cpu")
                if not isinstance(a, int):
                    a, b = dataclasses.astuple(a), dataclasses.astuple(b)
                check(a == b, f"small {mode} {sc}: card == CPU")
    with open(os.path.join(ROOT, "tests", "golden", "golden.json")) as f:
        golden = json.load(f)
    checked = 0
    for cls in golden["classes"]:
        if cls["maxlen"] > 1000:
            continue
        with open(os.path.join(ROOT, "tests", "golden", cls["fasta"])) as f:
            seqs, cur = [], []
            for line in f:
                if line.startswith(">"):
                    if cur:
                        seqs.append("".join(cur).encode())
                    cur = []
                else:
                    cur.append(line.strip())
            seqs.append("".join(cur).encode())
        for rec in cls["pairs"]:
            q, s = seqs[2 * rec["k"]], seqs[2 * rec["k"] + 1]
            for mode, want in rec["scores"].items():
                check(pt.align_score(q, s, mode, device="cuda") == want,
                      f"golden {cls['fasta']} {rec['k']} {mode} score")
                checked += 1
            for mode, want in (rec["alignments"] or {}).items():
                got = pt.align_full_tb(q, s, mode, device="cuda").compact()
                check(got == (want["q"], want["s"]),
                      f"golden {cls['fasta']} {rec['k']} {mode} strings")
                checked += 1
    # a small ragged batch across the 256 / 512 bucket edge
    qs, ss = zip(*[related_pair(rng, int(n))
                   for n in rng.integers(5, 300, 24)])
    for sc in (pt.LinearScoring(), pt.AffineScoring(*AFFINE)):
        for mode in ("global", "semiglobal", "local"):
            a = pt.align_scores_batch(qs, ss, mode, sc, device="cuda")
            b = pt.align_scores_batch(qs, ss, mode, sc, device="cpu")
            check(a.tolist() == b.tolist(), f"small batch {mode} {sc} scores")
            a = pt.align_batch(qs, ss, mode, sc, device="cuda")
            b = pt.align_batch(qs, ss, mode, sc, device="cpu")
            check([dataclasses.astuple(x) for x in a]
                  == [dataclasses.astuple(x) for x in b],
                  f"small batch {mode} {sc} alignments")
    print(f"phase3 small inputs: card == CPU plain, {checked} golden checks "
          f"equal", flush=True)


def cell_ops(affine: bool, args) -> float:
    """OPS a cell of a sweep launched on `args` (LOCAL: with the best)."""
    from anyseq_tpu_torch.core.types import Mode

    local = any(a is Mode.LOCAL for a in args)
    return OPS["affine" if affine else "linear"] + (OPS["best"] if local
                                                    else 0)


def walk_steps(out):
    """(steps, chain steps) of each walk of a walk's outputs (out_q, out_s,
    starts): the positions it writes, and those of them at cells of the
    matrix (i, j >= 0), a dependent load each. The GLOBAL halo's steps
    load nothing: its straight runs are written by the lanes at once. A
    step at (i, j) moves to (i - 1, j) unless out_q holds a gap, to
    (i, j - 1) unless out_s does, so its cell is the walk's stop cell
    (starts - 1) plus the moves of the steps up to it, in position
    order."""
    from anyseq_tpu_torch.core.types import EMPTY_SYM, GAP_SYM

    out_q, out_s, starts = out
    live = out_q != EMPTY_SYM
    i = starts[:, :1] - 1 + (live & (out_q != GAP_SYM)).int().cumsum(1)
    j = starts[:, 1:] - 1 + (live & (out_s != GAP_SYM)).int().cumsum(1)
    return live.sum(1), (live & (i >= 0) & (j >= 0)).sum(1)


def bound(fn: str, args, sm_clock_mhz: float):
    """(bound_ms, bound_by) of one launch of `fn` on `args`: the larger of
    the bytes it must move (each input read once, each output written
    once) over the card's memory rate and its int32 instructions (OPS a
    cell or a walk step) over 132 SMs x 64 int32 lanes x the top SM clock.
    A walk counts the steps this run's data takes (the positions it
    writes), and its bound is also no less than its chain: the longest
    walk's steps at cells of the matrix (walk_steps), each a dependent
    load of at least SHARED_LOAD_CYCLES, at the top SM clock ("chain")."""
    from anyseq_tpu_torch.kernels import band

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    peak_ops = sms * INT32_LANES_PER_SM * sm_clock_mhz * 1e6
    if fn.startswith("wavefront"):
        q, s, _, sc, preds = args[1:6]
        m, n = q.numel(), s.numel()
        affine = fn == "wavefront_affine"
        nbytes = m + n + 4 * (n + m + 3)
        if affine and args[7]:
            nbytes += 4 * m                          # the E last column
        if preds:
            nbytes += 4 * m * -(-n // (8 if affine else 16))
        ops = m * n * (cell_ops(affine, args)
                       + (OPS["codes4" if affine else "codes"] if preds
                          else 0))
    elif fn.startswith("band"):
        q, s = args[1], args[2]
        h, n = q.numel(), s.numel()
        affine = fn.endswith("_affine")
        # rows and columns in and out (H, and affine also F and E), and
        # each strip's best
        nbytes = (h + n + 4 * 2 * (n + h) * (2 if affine else 1)
                  + 12 * -(-n // (band.AFFINE_STRIP if affine
                                  else band.STRIP)))
        ops = h * n * cell_ops(affine, args)
    elif fn.startswith("walk"):
        live, inside = walk_steps(launcher(fn)(*args))
        steps = int(live.sum())
        nbytes = steps * (4 + 2 + 2) + 16 * live.numel()
        ops = steps * OPS["walk"]
        t_chain = (int(inside.max()) * SHARED_LOAD_CYCLES
                   / (sm_clock_mhz * 1e6))
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
        if t_chain > max(t_bytes, t_ops):
            return t_chain * 1e3, "chain"
    else:
        q, s, ms, ns = args[1:5]
        ms, ns = (torch.as_tensor(x).to(torch.int64) for x in (ms, ns))
        cells = int((ms * ns).sum())
        B, sum_m, sum_n = q.shape[0], int(ms.sum()), int(ns.sum())
        nbytes = sum_m + sum_n + 8 * B
        if fn.startswith("lastcols"):
            affine = fn == "lastcols_affine"
            nbytes += 4 * sum_m * (2 if affine else 1) + (B if affine else 0)
            ops = cells * cell_ops(affine, args)
        else:
            sc, sgaps, _, preds = args[6:10]
            affine = hasattr(sc, "gap_open")
            nbytes += B + 4 * (sum_m + sum_n) + 12 * B
            per_word = 8 if affine else 16
            if preds:
                nbytes += 4 * int((ms * (-(-ns // per_word))).sum())
            ops = cells * (cell_ops(affine, args)
                           + (OPS["codes4" if affine else "codes"] if preds
                              else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase2_band(rng, errors):
    """K8 and K8 affine against their plain versions on the card: two
    bands of BAND_ROWS rows of a related pair BAND_BP wide, in 3 modes
    (and affine GLOBAL start_gap). The first band starts from the
    closed-form boundary, and its bottom row must equal the unchained
    K1 / K5 sweep of those rows; the second starts from that sweep's last
    row (affine: with the first band's F row), as a chain hands it on,
    and runs once more with 1, 7 and strips - 1 warps; then a linear band
    from a boundary near SCORE_MIN, and affine bands from one near NEG."""
    from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
    from anyseq_tpu_torch.engine import affine, linmem
    from anyseq_tpu_torch.kernels import _build, band, wavefront

    dev = torch.device(DEVICE)
    qb, sb = related_pair(rng, BAND_BP)
    q = torch.frombuffer(bytearray(qb[:2 * BAND_ROWS]),
                         dtype=torch.uint8).to(dev)
    s = torch.frombuffer(bytearray(sb), dtype=torch.uint8).to(dev)
    n, h = s.numel(), BAND_ROWS
    lib = _build.library()
    cases = [(sc, mode, False)
             for sc in (LinearScoring(), AffineScoring(*AFFINE))
             for mode in (Mode.LOCAL, Mode.GLOBAL, Mode.SEMIGLOBAL)]
    cases.append((AffineScoring(*AFFINE), Mode.GLOBAL, True))
    for sc, mode, sg in cases:
        is_affine = isinstance(sc, AffineScoring)
        name = "band_affine" if is_affine else "band"
        tag = f"phase2 K8 {name} {mode.value} start_gap={sg}"
        if is_affine:
            first = (q[:h], s, *affine.top_row_affine(mode, sc, n, sg, dev),
                     *affine.left_col_affine(mode, sc, 0, h, sg, dev),
                     mode, sc)
            sweep = wavefront.launch_affine(lib, q[:h], s, mode, sc, False,
                                            sg, False)
        else:
            first = (q[:h], s, linmem.top_row(mode, sc, n, dev),
                     *linmem.left_col(mode, sc, 0, h, dev), mode, sc)
            sweep = wavefront.launch(lib, q[:h], s, mode, sc, False)
        kernel, plain = launcher(name), getattr(band, "plain_affine"
                                                if is_affine else "plain")
        err, _, _ = compare(f"{tag} band 0 {h}x{n}",
                            lambda: kernel(lib, *first),
                            lambda: plain(*first))
        errors[name] = max(errors.get(name, 0), err)
        top = kernel(lib, *first)
        check(torch.equal(top["last_row"], sweep["last_row"]),
              f"{tag}: band 0's bottom row == the unchained sweep's")
        if is_affine:
            second = (q[h:], s, sweep["last_row"], top["last_row_f"],
                      *affine.left_col_affine(mode, sc, h, h, sg, dev),
                      mode, sc)
        else:
            second = (q[h:], s, sweep["last_row"],
                      *linmem.left_col(mode, sc, h, h, dev), mode, sc)
        err, _, _ = compare(f"{tag} band 1 {h}x{n}",
                            lambda: kernel(lib, *second),
                            lambda: plain(*second))
        errors[name] = max(errors.get(name, 0), err)
        strips = -(-n // (band.AFFINE_STRIP if is_affine else band.STRIP))
        want = plain(*second)
        grids = [1, 7, strips - 1]
        for grid in grids:
            err = max_abs_err(kernel(lib, *second, grid=grid), want)
            check(err == 0, f"{tag} band 1 with {grid} warps for {strips} "
                            f"strips")
        print(f"{tag} band 1 with {grids} warps for {strips} strips "
              f"equal=True (chosen: {band_grid(name, h, n, mode)})",
              flush=True)
    # K8 from a boundary a little above SCORE_MIN (no sum leaves int32's
    # range), and K8 affine from one on both sides of NEG with ge = 0 and
    # with go = 0 (also one column wide, where E's NEG + go floor shows),
    # from their own generator so that the main paths' pairs stay those of
    # every earlier run
    from anyseq_tpu_torch.core.types import NEG, SCORE_MIN
    near = np.random.default_rng(SEED + 1)

    def edge(base, size):
        return torch.from_numpy(base + near.integers(0, 500, size)
                                .astype(np.int32)).to(dev)

    base = SCORE_MIN + 2**20
    row, col = edge(base, n), edge(base, h)
    for mode in (Mode.LOCAL, Mode.GLOBAL, Mode.SEMIGLOBAL):
        args = (q[:h], s, row, base + 3, col, mode, LinearScoring())
        err = max_abs_err(band.launch(lib, *args), band.plain(*args))
        check(err == 0, f"K8 near SCORE_MIN {mode.value}")
        errors["band"] = max(errors.get("band", 0), err)
        print(f"phase2 K8 band {mode.value} {h}x{n} from a boundary near "
              f"SCORE_MIN equal=True", flush=True)
    base = NEG - 250
    for sc in (AffineScoring(1, -6, -4, 0), AffineScoring(2, -1, 0, -1)):
        for w in (n, 1):
            args = (q[:h], s[:w], edge(base, w), edge(base, w), base + 3,
                    edge(base, h), edge(base, h))
            for mode in (Mode.LOCAL, Mode.GLOBAL, Mode.SEMIGLOBAL):
                err = max_abs_err(band.launch_affine(lib, *args, mode, sc),
                                  band.plain_affine(*args, mode, sc))
                check(err == 0, f"K8 affine near NEG {sc} {mode.value} {w}")
                errors["band_affine"] = max(errors["band_affine"], err)
            print(f"phase2 K8 band_affine {sc} {h}x{w} from a boundary "
                  f"near NEG, 3 modes equal=True", flush=True)


def band_mode(mode) -> int:
    """The C entry points' code of a Mode."""
    from anyseq_tpu_torch.kernels._sweep import MODE_CODE

    return MODE_CODE[mode]


def band_grid(fn: str, h: int, n: int, mode) -> int:
    """The warps the band kernel `fn` (band, band_affine or their
    collective modes) chooses for h x n in `mode`, alone on the card."""
    from anyseq_tpu_torch.kernels import _build

    lib = _build.library()
    grid_of = (lib.anyseq_band_affine_grid if fn.endswith("_affine")
               else lib.anyseq_band_grid)
    return grid_of(h, n, band_mode(mode), 1, 0)


@contextlib.contextmanager
def plain_collectives():
    """K10 launches replaced by their plain versions inside the block, each
    on idle cards: the plain versions of a sweep's ranks then run one after
    another, in rank order, as on the CPU."""
    from anyseq_tpu_torch.kernels import band

    real = band.launch_collective, band.launch_collective_affine

    def idle():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)

    def plain(fn):
        def run(lib, *args, **kwargs):
            idle()
            out = fn(*args)
            idle()
            return out
        return run

    band.launch_collective = plain(band.plain_collective)
    band.launch_collective_affine = plain(band.plain_collective_affine)
    try:
        yield
    finally:
        band.launch_collective, band.launch_collective_affine = real


def rings():
    """The device lists phase 2 runs K10 over: 2 and 4 ranks of cuda:0,
    and every card where there are several."""
    out = [["cuda:0"] * 2, ["cuda:0"] * 4]
    if torch.cuda.device_count() >= 2:
        out.append([f"cuda:{i}" for i in range(torch.cuda.device_count())])
    return out


@contextlib.contextmanager
def collective_grid(grid: int):
    """K10 and K10 affine launches made with `grid` warps inside the
    block."""
    from anyseq_tpu_torch.kernels import band

    real = band.launch_collective, band.launch_collective_affine

    def capped(fn):
        return lambda *a, **k: fn(*a, **{**k, "grid": grid})

    band.launch_collective, band.launch_collective_affine = map(capped, real)
    try:
        yield
    finally:
        band.launch_collective, band.launch_collective_affine = real


def phase2_collective(rng, errors):
    """K10 and K10 affine against their plain versions on the card, over
    each of rings(): two chained bands of COLL_ROWS rows of a related pair
    COLL_BP wide, in 3 modes (and affine GLOBAL start_gap), also with 1,
    7 and strips - 1 warps a rank; then the same rows against a subject
    that leaves the last rank without columns."""
    from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
    from anyseq_tpu_torch.dist import collective
    from anyseq_tpu_torch.kernels import band

    dev = torch.device(DEVICE)
    qb, sb = related_pair(rng, COLL_BP)
    q = torch.frombuffer(bytearray(qb[:2 * COLL_ROWS]),
                         dtype=torch.uint8).to(dev)
    s_full = torch.frombuffer(bytearray(sb), dtype=torch.uint8).to(dev)
    cases = [(sc, mode, False)
             for sc in (LinearScoring(), AffineScoring(*AFFINE))
             for mode in (Mode.LOCAL, Mode.GLOBAL, Mode.SEMIGLOBAL)]
    cases.append((AffineScoring(*AFFINE), Mode.GLOBAL, True))
    for ring in rings():
        K = len(ring)
        # n where the last rank has no columns: Nl = 1024, K - 1 active
        s_empty = s_full[:(K - 1) * band.STRIP - 100]
        for s in (s_full, s_empty):
            Nl, active, _, bands = collective.geometry(q.numel(), s.numel(),
                                                       K, COLL_ROWS)
            for sc, mode, sg in cases:
                name = ("band_collective_affine" if isinstance(sc, AffineScoring)
                        else "band_collective")

                def run():
                    return collective.launch_pair(
                        q, s, mode, sc, collective.ranks_of(ring), COLL_ROWS,
                        sg)()

                memo = {}

                def plain():
                    # once a case: the grid checks below reuse it
                    if not memo:
                        with plain_collectives():
                            memo["out"] = run()
                    return memo["out"]

                label = (f"phase2 K10 {name} {mode.value} start_gap={sg} "
                         f"over {K} ranks {'+'.join(ring)} ({active} with "
                         f"columns, {bands} bands) {q.numel()}x{s.numel()}")
                err, _, _ = compare(label, run, plain, reps=2)
                errors[name] = max(errors.get(name, 0), err)
                want = plain()
                strips = Nl // (band.AFFINE_STRIP if isinstance(
                    sc, AffineScoring) else band.STRIP)
                grids = sorted({1, 7, max(strips - 1, 1)})
                for grid in grids:
                    with collective_grid(grid):
                        err = max_abs_err(run(), want)
                    check(err == 0, f"{label} with {grid} warps a rank")
                print(f"{label} with {grids} warps a rank equal=True",
                      flush=True)


def phase2_swarm(rng, errors, lib=None):
    """K7 on the warp strip cores (``csrc/swarm.cu``) against its plain
    version on the card, bit for bit, in 3 modes, each with and without
    codes and (LOCAL) without positions; linear 2/-1/-1 and affine
    2/-1/-3/-1 with mixed start-gap flags, and the affine chain's edges
    (ge = 0, go = 0): at each width forced, problems of n = 1, 31, 32 W - 1,
    32 W and 32 W + 1 columns by m = 1, 17, 32 and 33 rows, a tall (1500 x
    40) and a wide (20 x 1500) one; 256 problems of up to 600 x 3000 (one
    to twelve strips a launch); LOCAL ties across lanes and strips (runs
    of one symbol, and a scoring whose maxima are single matches); 64
    problems of up to 4,500 x 4,500. `rng` is the phase's own generator."""
    from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
    from anyseq_tpu_torch.kernels import _build, swarm

    lib = lib or _build.library()
    dev = torch.device(DEVICE)
    sc, asc = LinearScoring(), AffineScoring(*AFFINE)
    edges = (AffineScoring(1, -6, -4, 0), AffineScoring(2, -1, 0, -1))
    variants = ((True, False), (False, False), (True, True))

    def batch_of(shapes, alphabet=b"ACGT"):
        """Random problems of the given (m, n) shapes, padded with real
        symbols, and their lengths."""
        ms_ = np.array([m for m, _ in shapes])
        ns_ = np.array([n for _, n in shapes])
        sym = np.frombuffer(alphabet, np.uint8)
        q = sym[rng.integers(0, len(sym), (len(shapes), ms_.max()))]
        s = sym[rng.integers(0, len(sym), (len(shapes), ns_.max()))]
        return (torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev),
                torch.from_numpy(ms_).to(dev), torch.from_numpy(ns_).to(dev))

    def held(label, q, s, ms_, ns_, scoring, width=0, modes=tuple(Mode),
             cases=variants):
        affine = isinstance(scoring, AffineScoring)
        sg = (torch.from_numpy(rng.integers(0, 2, q.shape[0]).astype(bool))
              .to(dev) if affine else None)
        t0, plain_s = time.perf_counter(), 0.0
        for mode in modes:
            for need_pos, preds in cases:
                if preds and width and width not in swarm.widths_of(affine,
                                                                   True):
                    continue
                args = (q, s, ms_, ns_, mode, scoring, sg, need_pos, preds)
                got = swarm.launch(lib, *args, width=width)
                plan = swarm.last_plan
                t1 = time.perf_counter()
                want = swarm.plain(*args)
                plain_s += time.perf_counter() - t1
                err = max_abs_err(got, want)
                name = "swarm_preds" if preds else "swarm_score"
                check(err == 0, f"phase2 K7 {label} {mode.value} {scoring} "
                                f"need_pos={need_pos} preds={preds} width "
                                f"{plan.width}: kernel == plain "
                                f"(max_abs_err {err})")
                errors[name] = max(errors.get(name, 0), err)
        print(f"phase2 K7 {label} {scoring} B={q.shape[0]} up to "
              f"{int(ms_.max())}x{int(ns_.max())} width={width or 'rule'} "
              f"strips={plan.strips} equal=True "
              f"({time.perf_counter() - t0 - plain_s:.1f} s, plain "
              f"{plain_s:.1f} s)", flush=True)

    for scoring in (sc, asc):
        affine = isinstance(scoring, AffineScoring)
        for w in swarm.widths_of(affine, False):
            strip = 32 * w
            shapes = [(m, n) for m in (1, 17, 32, 33)
                      for n in (1, 31, strip - 1, strip, strip + 1)]
            held(f"edges W={w}", *batch_of(shapes + [(1500, 40), (20, 1500)]),
                 scoring, width=w)
    for scoring in (sc, asc, *edges):
        shapes = list(zip(rng.integers(1, 601, 256), rng.integers(1, 3001,
                                                                  256)))
        held("mixed strips", *batch_of(shapes), scoring)
    # LOCAL ties: runs of one symbol (maxima along a row, across lanes and
    # strips) and single matches among 20 symbols at -100 (maxima 1 all
    # over the matrix)
    for scoring in (sc, asc, LinearScoring(1, -100, -100),
                    AffineScoring(1, -100, -100, -1)):
        affine = isinstance(scoring, AffineScoring)
        sparse = scoring.match == 1
        shapes = [(m, n) for m in (1, 5, 40, 300) for n in (3, 300, 700)]
        for w in swarm.widths_of(affine, False):
            q, s, ms_, ns_ = batch_of(
                shapes, b"ACDEFGHIKLMNPQRSTVWY" if sparse else b"A")
            held(f"ties W={w}", q, s, ms_, ns_, scoring, width=w,
                 modes=(Mode.LOCAL,))
    for scoring in (sc, asc):
        shapes = list(zip(rng.integers(1000, SWARM_LARGE_BP + 1, 64),
                          rng.integers(1000, SWARM_LARGE_BP + 1, 64)))
        held("large", *batch_of(shapes), scoring,
             cases=((True, False), (True, True)))


def phase2_swarm_affine_codes(rng, errors):
    """K7's affine 4-bit codes against the plain version on the card:
    4,096 ragged problems of up to 256 x 256, 3 modes, mixed start-gap
    flags (the mode is on no main path; its time is PERF.md's)."""
    from anyseq_tpu_torch.core.types import AffineScoring, Mode
    from anyseq_tpu_torch.kernels import swarm

    dev = torch.device(DEVICE)
    q3, s3, ms_, ns_ = random_batch(rng, dev, 4096, 256, 256)
    B, M, N = q3.shape[0], q3.shape[1], s3.shape[1]
    sg = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    asc = AffineScoring(*AFFINE)
    for mode in (Mode.LOCAL, Mode.GLOBAL, Mode.SEMIGLOBAL):
        args = (q3, s3, ms_, ns_, mode, asc, sg, True, True)
        err, ms, _ = compare(
            f"phase2 K7 swarm_preds affine codes {mode.value} {B} problems "
            f"up to {M}x{N}", lambda: swarm.score_pairs_swarm(*args),
            lambda: swarm.plain(*args))
        plan = swarm.last_plan
        b_ms, by = bound("swarm", (None, *args), sm_clock_of())
        print(f"phase2 K7 affine codes {mode.value} width={plan.width} "
              f"warps={plan.warps} strips={plan.strips} bound_ms={b_ms:.4f} "
              f"bound_by={by} share={b_ms / ms:.3f}", flush=True)
        errors["swarm_preds"] = max(errors.get("swarm_preds", 0), err)


# the sources whose ptxas report phase 1 prints, those among them that
# must not spill and whose SASS must hold the chain's DPX instructions
# (the warp strip cores), and the walks, which must not spill either (a
# window's loads wait in registers)
PTXAS_SOURCES = ("lastcols.cu", "lastcols_affine.cu", "band.cu",
                 "band_affine.cu", "swarm.cu", "walk.cu", "walk_affine.cu")
WARP_CORES = ("band.cu", "band_affine.cu", "lastcols.cu",
              "lastcols_affine.cu", "swarm.cu")
WALK_CORES = ("walk.cu", "walk_affine.cu")


def kernel_args(mangled: str):
    """(kernel name, its template arguments) of a mangled entry function:
    the flags (LOCAL, PREDS, ...) as 0/1 digits, then, for the warp strip
    cores, the strip shape's columns a lane and rows a step, e.g.
    ``band_kernel``, ``1/8/1``."""
    import re

    # _Z[N<scope>]<len><name>kernelI<Lb0E|Lb1E...>[N...GeomILi8ELi1EE]E
    k = re.search(r"\d([A-Za-z_]*kernel)(I.*?E)v", mangled)
    if not k:
        k = re.search(r"\d([A-Za-z_]*kernel)", mangled)
        return (k.group(1) if k else mangled), ""
    args = re.findall(r"L([bi])(\d+)E", k.group(2))
    flags = "".join(v for kind, v in args if kind == "b")
    ints = [v for kind, v in args if kind == "i"]
    return k.group(1), "/".join([flags] + ints)


def ptxas_entries(out: str):
    """(kernel, template arguments, mangled name, registers, spill bytes)
    of each entry function in the output of ``nvcc -Xptxas -v``."""
    import re

    entries, name = [], None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = (*kernel_args(m.group(1)), m.group(1))
            spills = None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            entries.append((*name, int(m.group(1)), spills))
            name = None
    return entries


def build_report():
    """Start nvcc with ``-Xptxas -v`` on PTXAS_SOURCES (beside the main
    build); returns a function that waits for them, prints each kernel's
    registers and spills, and then checks that the warp strip cores and
    the walks spill nothing and that the cores' SASS holds the chain's
    DPX instructions."""
    import tempfile

    from anyseq_tpu_torch.kernels import _build

    tmp = tempfile.TemporaryDirectory()
    nvcc = _build._nvcc()
    procs = {}
    for name in PTXAS_SOURCES:
        obj = os.path.join(tmp.name, name + ".o")
        procs[name] = (obj, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
             str(_build.CSRC / name)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    def report():
        failed = []
        with tmp:
            for name, (obj, proc) in procs.items():
                out = proc.communicate()[0]
                check(proc.returncode == 0, f"nvcc -Xptxas -v {name}:\n{out}")
                entries = ptxas_entries(out)
                check(entries, f"ptxas reported the kernels of {name}")
                dpx = {}
                if name in WARP_CORES:
                    sass = subprocess.run(
                        [os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                         "-sass", obj], capture_output=True, text=True,
                        check=True).stdout
                    # one section a kernel: "Function : <mangled name>"
                    for part in sass.split("Function : ")[1:]:
                        dpx[part.split()[0]] = {
                            op: part.count(op)
                            for op in ("VIADDMNMX", "VIMNMX3")}
                for kernel, flags, mangled, regs, spills in entries:
                    counts = dpx.get(mangled)
                    print(f"phase1 ptxas {name} {kernel}<{flags}>: {regs} "
                          f"registers, {spills} bytes spilled"
                          + (f", DPX {json.dumps(counts)}" if counts
                             else ""), flush=True)
                    if name in WARP_CORES + WALK_CORES and spills != 0:
                        failed.append(f"{name} {kernel}<{flags}> spills "
                                      f"nothing")
                    if name in WARP_CORES:
                        # the chain's max-plus in every kernel; the
                        # three-way max of the best where there is one (the
                        # level sweeps K4 and K5L have none, nor K7 but
                        # LOCAL: swarm_kernel<AFFINE, LOCAL, G, PREDS>)
                        best = not (name.startswith("lastcols")
                                    or name == "swarm.cu"
                                    and flags[1] == "0")
                        if not (counts and counts["VIADDMNMX"] > 0
                                and (counts["VIMNMX3"] > 0 or not best)):
                            failed.append(f"{name} {kernel}<{flags}>'s "
                                          f"SASS holds DPX")
        # every kernel's line first, then each failed check
        check(not failed, "; ".join(failed))
    return report


def sm_clock_of() -> float:
    """The card's top SM clock in MHz (nvidia-smi)."""
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()
    return float(clock[torch.cuda.current_device()])


def phase3_genome(rng, kept, counts):
    """The genome path through the public API, driven with every launch
    count set to 0 just before it and read just after; each call with its
    wall, GCUPS and launches. Then the checks of the module docstring,
    and the band-fill cost of ResumableScorer bands."""
    import dataclasses
    import tempfile

    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch.core.types import Mode, as_tensor
    from anyseq_tpu_torch.engine import hirschberg
    from anyseq_tpu_torch.engine.resumable import ResumableScorer
    from anyseq_tpu_torch.kernels import _build, band, wavefront

    sc = pt.LinearScoring()
    asc = pt.AffineScoring(*AFFINE)
    q1, s1 = related_pair(rng, GENOME_BP)
    q5, s5 = related_pair(rng, CKPT_BP)
    q6, s6 = related_pair(rng, ECOLI_BP)
    q7, s7 = related_pair(rng, HB_GENOME_BP)
    score_1 = ("align_score", GENOME_BP, "global", "LinearScoring")
    score_2 = ("align_score", GENOME_BP, "local", "AffineScoring")
    align_3 = ("align", GENOME_BP, "semiglobal", "LinearScoring")
    resume_4 = ("ResumableScorer", GENOME_BP, "global", "LinearScoring")
    ckpt_5 = ("align_hirschberg", CKPT_BP, "semiglobal", "AffineScoring")
    ecoli_6 = ("align_score", ECOLI_BP, "global", "LinearScoring")
    align_7 = ("align", HB_GENOME_BP, "global", "LinearScoring")
    align_8 = ("align", HB_GENOME_BP, "global", "AffineScoring")

    class Killed(Exception):
        pass

    def resumed(path):
        """Call 4: 5 bands, a new object, the rest."""
        r = ResumableScorer(q1, s1, "global", sc, band_rows=RESUME_BAND_ROWS,
                            checkpoint_path=path, device=DEVICE)
        for _ in range(5):
            r.step()
        del r
        r = ResumableScorer.resume(path, q1, s1, "global", sc,
                                   band_rows=RESUME_BAND_ROWS, device=DEVICE)
        check(r.band == 5, f"resumed at band {r.band} == 5")
        r.run()
        return r

    def killed_and_resumed(path):
        """Call 5: a clean run, a run whose second save raises, and the
        rerun that resumes from that save."""
        clean = hirschberg.align_hirschberg(q5, s5, "semiglobal", asc,
                                            device=DEVICE)
        save, saves = hirschberg._HbCheckpoint.save, [0]

        def save_then_fail(self, **arrays):
            save(self, **arrays)
            saves[0] += 1
            if saves[0] == 2:
                raise Killed()

        hirschberg._HbCheckpoint.save = save_then_fail
        try:
            hirschberg.align_hirschberg(q5, s5, "semiglobal", asc,
                                        device=DEVICE, checkpoint_path=path)
            check(False, "the checkpointed run was killed at its 2nd save")
        except Killed:
            pass
        finally:
            hirschberg._HbCheckpoint.save = save
        again = hirschberg.align_hirschberg(q5, s5, "semiglobal", asc,
                                            device=DEVICE,
                                            checkpoint_path=path)
        check(dataclasses.astuple(again) == dataclasses.astuple(clean),
              "100k semiglobal affine: resumed run == clean run")
        return again

    sweeps, levels = {}, []
    real_score = wavefront.score
    real_per_half = hirschberg._level_per_half

    def keep_sweep(*args, **kwargs):
        out = real_score(*args, **kwargs)
        if current[0] in (score_1, score_2):
            sweeps[current[0]] = out
        return out

    def per_half(q, s, parts, sc, mesh=None):
        levels.append((current[0], len(parts),
                       max(p[1] - p[0] for p in parts)))
        return real_per_half(q, s, parts, sc, mesh)

    calls = (
        (score_1, q1, s1, lambda: pt.align_score(q1, s1, "global", sc,
                                                 device=DEVICE)),
        (score_2, q1, s1, lambda: pt.align_score(q1, s1, "local", asc,
                                                 device=DEVICE)),
        (align_3, q1, s1, lambda: pt.align(q1, s1, "semiglobal", sc,
                                           device=DEVICE)),
        (resume_4, q1, s1, lambda: resumed(os.path.join(tmp, "r.npz"))),
        (ckpt_5, q5, s5, lambda: killed_and_resumed(
            os.path.join(tmp, "hb.npz"))),
        (ecoli_6, q6, s6, lambda: pt.align_score(q6, s6, "global", sc,
                                                 device=DEVICE)),
        (align_7, q7, s7, lambda: pt.align(q7, s7, "global", sc,
                                           device=DEVICE)),
        (align_8, q7, s7, lambda: pt.align(q7, s7, "global", asc,
                                           device=DEVICE)),
    )
    torch.cuda.synchronize()
    for k in _build.launches:
        _build.launches[k] = 0
    current = [None]
    results, deltas = {}, {}
    wavefront.score = keep_sweep
    hirschberg._level_per_half = per_half
    try:
        with kept_launches(kept, current), \
                tempfile.TemporaryDirectory() as tmp:
            for call, q, s, fn in calls:
                current[0] = call
                before = dict(_build.launches)
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
                delta = {k: v - before[k] for k, v in _build.launches.items()
                         if v > before[k]}
                score = (out if isinstance(out, int) else out.score()[0]
                         if call is resume_4 else out.score)
                # peak_gb: the allocator's peak during the call; the call's
                # own is that less what earlier calls' kept inputs hold
                print(f"phase3 {' '.join(map(str, call))} "
                      f"{len(q)}x{len(s)} score={score} wall_s={wall:.4f} "
                      f"gcups={len(q) * len(s) / wall / 1e9:.2f} "
                      f"peak_gb={peak / 1e9:.3f} "
                      f"call_peak_gb={(peak - held) / 1e9:.3f} "
                      f"launches={json.dumps(delta)}", flush=True)
                results[call], deltas[call] = out, delta
                GENOME_WALLS[call] = wall
                if call is ecoli_6:
                    check(score == ECOLI_SCORE,
                          f"4.6 Mbp global score {score} == {ECOLI_SCORE}")
                    bands = -(-len(q) // band.M_BAND)
                    check(delta == {"band": bands},
                          f"4.6 Mbp global ran {bands} K8 bands alone "
                          f"({delta})")
    finally:
        wavefront.score = real_score
        hirschberg._level_per_half = real_per_half
    read_counts("genome", counts)
    lib = _build.library()
    SINGLE["genome"] = {"q1": q1, "s1": s1, "q6": q6, "s6": s6,
                        "score 1 Mbp local affine": results[score_2],
                        "align 1 Mbp semiglobal": results[align_3],
                        "score 4.6 Mbp global": results[ecoli_6]}

    # calls 1 and 2: the chain against one unchained sweep of the pair
    q, s = as_tensor(q1, DEVICE), as_tensor(s1, DEVICE)
    for call, want in (
            (score_1, lambda: wavefront.launch(lib, q, s, Mode.GLOBAL, sc,
                                               False)),
            (score_2, lambda: wavefront.launch_affine(
                lib, q, s, Mode.LOCAL, asc, False, False, False))):
        err = max_abs_err(sweeps[call], want())
        check(err == 0, f"{' '.join(map(str, call))}: chained == unchained")
        print(f"phase3 {' '.join(map(str, call))}: {len(q1)}x{len(s1)} "
              f"chained bands == one unchained sweep (last_row, last_col, "
              f"best)", flush=True)
    del q, s

    # call 3: rescored from its strings
    aln = results[align_3]
    again = pt.align_score(q1, s1, "semiglobal", sc, device=DEVICE)
    got = rescore(aln, sc)
    check(got == aln.score == again,
          f"1 Mbp semiglobal rescore {got} == score {aln.score} == "
          f"align_score {again}")
    print(f"phase3 1 Mbp semiglobal rescored={got} align_score={again} "
          f"equal=True", flush=True)

    # call 4: the resumed run == call 1's chain; then the band fill
    r = results[resume_4]
    outs, want = r.outputs(), sweeps[score_1]
    check(all(torch.equal(outs[k], want[k]) for k in ("last_row", "last_col"))
          and r.score()[0] == results[score_1],
          "resumed ResumableScorer == call 1")
    print(f"phase3 ResumableScorer resumed after 5 of {r.num_bands} bands: "
          f"last_row, last_col, score == call 1", flush=True)
    for rows in (FILL_BAND_ROWS, RESUME_BAND_ROWS):
        r = ResumableScorer(q1, s1, "global", sc, band_rows=rows,
                            device=DEVICE)
        bands = RESUME_BAND_ROWS // rows
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(bands):
            r.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"phase3 ResumableScorer band fill: {bands} bands of {rows} "
              f"rows x {len(s1)} wall_s={wall:.4f} "
              f"ms_per_band={wall / bands * 1e3:.3f} "
              f"us_per_row={wall / (bands * rows) * 1e6:.3f}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        r.path = os.path.join(tmp, "r.npz")
        t0 = time.perf_counter()
        r.save()
        print(f"phase3 ResumableScorer save of {len(q1)}x{len(s1)} state: "
              f"{os.path.getsize(r.path)} bytes in "
              f"{time.perf_counter() - t0:.4f} s", flush=True)
    del r

    # call 6: the peak memory beside one K1 sweep's boundary columns (the
    # mesh path holds its score to the collective sweep's)
    m6, n6 = len(q6), len(s6)
    k1_bytes = (-(-n6 // 1024) - 1) * m6 * 4
    print(f"phase3 4.6 Mbp global: K1's boundary columns would take "
          f"{k1_bytes / 1e9:.1f} GB", flush=True)

    # calls 7 and 8: K8 (K8 affine) inside the levels, a level of more
    # than 2 parts whose tallest passes M_MAX run per half, and the strings
    # rescored
    for call, scoring, kernel in ((align_7, sc, "band"),
                                  (align_8, asc, "band_affine")):
        name = f"2.2 Mbp global {call[3]}"
        runs = [(p, tall) for c, p, tall in levels if c == call]
        print(f"phase3 {name} align: levels run per half (parts, tallest "
              f"part) {runs}", flush=True)
        check(deltas[call].get(kernel, 0) > 0, f"{name} align ran {kernel}")
        check(any(p > 2 and tall > band.M_MAX for p, tall in runs),
              f"{name} align ran a level of > 2 parts taller than M_MAX "
              f"per half")
        aln = results[call]
        again = pt.align_score(q7, s7, "global", scoring, device=DEVICE)
        got = rescore(aln, scoring)
        check(got == aln.score == again,
              f"{name} rescore {got} == score {aln.score} == "
              f"align_score {again}")
        print(f"phase3 {name} rescored={got} align_score={again} "
              f"equal=True", flush=True)


def mesh_devices():
    """The mesh path's devices: every card where there are two or more,
    else 2 ranks of cuda:0."""
    count = torch.cuda.device_count()
    if count >= 2:
        return [f"cuda:{i}" for i in range(count)]
    return ["cuda:0"] * 2


def phase3_mesh(rng, kept, counts):
    """The mesh path through the public multi-device entry points, driven
    with every launch count set to 0 just before it and read just after;
    each call with its wall, GCUPS and launches, and held to the
    single-device result of the same inputs from the earlier paths."""
    import dataclasses

    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch.dist import batch as dist_batch
    from anyseq_tpu_torch.dist.collective import score_pairs_collective
    from anyseq_tpu_torch.dist.dryrun import dryrun_multichip
    from anyseq_tpu_torch.dist.mesh import make_mesh
    from anyseq_tpu_torch.dist.sharded import score_pair_sharded
    from anyseq_tpu_torch.engine import linmem
    from anyseq_tpu_torch.kernels import _build

    print("phase3 mesh: nvidia-smi -L:\n" + subprocess.run(
        ["nvidia-smi", "-L"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    devices = mesh_devices()
    mesh = make_mesh(devices=devices)
    print(f"phase3 mesh: {'every card' if len(set(devices)) > 1 else '2 ranks of cuda:0'}"
          f" {mesh}", flush=True)
    sc = pt.LinearScoring()
    asc = pt.AffineScoring(*AFFINE)
    g = SINGLE["genome"]
    q5, s5, mm = SINGLE["align 100k semiglobal affine"]
    qs, ss, batch_scores, batch_alns = SINGLE["batch 10k local"]
    pairs = [related_pair(rng, MESH_2D_BP) for _ in range(3)]

    def score(q, s, mode, scoring):
        outs = score_pair_sharded(q, s, mode, scoring, mesh)
        return int(linmem.extract_end(outs, len(q), len(s), mode)[0])

    def two_d(scoring):
        return score_pairs_collective(
            [p[0] for p in pairs], [p[1] for p in pairs], "global", scoring,
            make_mesh(dp=2, sp=2, devices=[mesh_devices()[0]] * 4))

    t = lambda aln: dataclasses.astuple(aln)   # noqa: E731
    calls = (
        ("score_pair_sharded 4.6 Mbp global linear", g["q6"], g["s6"],
         lambda: score(g["q6"], g["s6"], "global", sc),
         lambda out: out == g["score 4.6 Mbp global"]),
        ("score_pair_sharded 1 Mbp local affine", g["q1"], g["s1"],
         lambda: score(g["q1"], g["s1"], "local", asc),
         lambda out: out == g["score 1 Mbp local affine"]),
        ("align(mesh=) 1 Mbp semiglobal linear", g["q1"], g["s1"],
         lambda: pt.align(g["q1"], g["s1"], "semiglobal", sc, mesh=mesh),
         lambda out: t(out) == t(g["align 1 Mbp semiglobal"])),
        ("align(mesh=) 100k semiglobal affine", q5, s5,
         lambda: pt.align(q5, s5, "semiglobal", asc, mesh=mesh),
         lambda out: t(out) == t(mm)),
        ("align_scores_batch_sharded 10,000 local pairs ~256 bp", qs, ss,
         lambda: dist_batch.align_scores_batch_sharded(qs, ss, "local", sc,
                                                       mesh),
         lambda out: out.tolist() == batch_scores.tolist()),
        ("align_batch(mesh=) 10,000 local pairs ~256 bp", qs, ss,
         lambda: pt.align_batch(qs, ss, "local", sc, mesh=mesh),
         lambda out: [t(a) for a in out] == [t(a) for a in batch_alns]),
        (f"dryrun_multichip({len(devices)})", [b"A"], [b"A"],
         lambda: dryrun_multichip(len(devices), devices), lambda out: True),
        ("score_pairs_collective 2x2 of cuda:0, 3 pairs global linear",
         [p[0] for p in pairs], [p[1] for p in pairs], lambda: two_d(sc),
         lambda out: [r[0] for r in out] == [
             pt.align_score(a, b, "global", sc, device=DEVICE)
             for a, b in pairs]),
        ("score_pairs_collective 2x2 of cuda:0, 3 pairs global affine",
         [p[0] for p in pairs], [p[1] for p in pairs], lambda: two_d(asc),
         lambda out: [r[0] for r in out] == [
             pt.align_score(a, b, "global", asc, device=DEVICE)
             for a, b in pairs]),
    )
    torch.cuda.synchronize()
    for k in _build.launches:
        _build.launches[k] = 0
    current, outs = [None], {}
    with kept_launches(kept, current):
        for name, q, s, fn, _ in calls:
            current[0] = name
            before = dict(_build.launches)
            t0 = time.perf_counter()
            outs[name] = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cells = (sum(len(a) * len(b) for a, b in zip(q, s))
                     if isinstance(q, list) else len(q) * len(s))
            delta = {k: v - before[k] for k, v in _build.launches.items()
                     if v > before[k]}
            MESH_WALLS[name] = wall
            print(f"phase3 mesh {name} cells={cells} wall_s={wall:.4f} "
                  f"gcups={cells / wall / 1e9:.2f} "
                  f"launches={json.dumps(delta)}", flush=True)
    read_counts("mesh", counts)
    for name, _, _, _, same in calls:
        check(same(outs[name]), f"mesh: {name} == the single-device result")
    print(f"phase3 mesh: all {len(calls)} calls equal to the single-device "
          f"results (4.6 Mbp score {outs[calls[0][0]]})", flush=True)


# the two-process path (phase3_processes): its calls, each run by two
# worker processes that share cuda:0, joined over torch.distributed
PROCESS_BP = 1_000_000
PROCESS_BAND_ROWS = (262_144, 65_536)    # the hand-off's band heights
PROCESS_TIMEOUT_S = 420                  # a worker's limit


def processes_inputs():
    """The two-process path's inputs, from a generator of their own (the
    workers draw the same): a 1 Mbp pair, a 100k pair and 10,000 pairs of
    ~256 bp."""
    rng = np.random.default_rng(SEED + 20)
    big = related_pair(rng, PROCESS_BP)
    mid = related_pair(rng, 100_000)
    qs, ss = zip(*[related_pair(rng, 256) for _ in range(10_000)])
    return big, mid, (list(qs), list(ss))


def processes_calls(mesh):
    """(name, cells, call, summary) of the two-process path: each call
    over `mesh` (None: on one device), and the summary of its result that
    both workers and the single device must give alike."""
    import hashlib

    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch.dist import batch as dist_batch
    from anyseq_tpu_torch.dist.sharded import score_pair_sharded
    from anyseq_tpu_torch.engine import linmem

    sc = pt.LinearScoring()
    asc = pt.AffineScoring(*AFFINE)
    (q1, s1), (q5, s5), (qs, ss) = processes_inputs()

    def score(q, s, mode, scoring, rows=None):
        if mesh is None:
            return pt.align_score(q, s, mode, scoring, device=DEVICE)
        outs = score_pair_sharded(q, s, mode, scoring, mesh, band_rows=rows)
        return int(linmem.extract_end(outs, len(q), len(s), mode)[0])

    def align(mode, scoring):
        if mesh is None:
            return pt.align(q5, s5, mode, scoring, traceback="hirschberg",
                            device=DEVICE)
        return pt.align(q5, s5, mode, scoring, mesh=mesh)

    def aligned(aln, scoring):
        """An alignment's score, start, strings' digest and rescore."""
        digest = hashlib.sha256(aln.query_aligned + b"|"
                                + aln.subject_aligned).hexdigest()
        return [aln.score, list(aln.start), digest, rescore(aln, scoring)]

    def batch():
        if mesh is None:
            return pt.align_batch(qs, ss, "local", sc, device=DEVICE)
        return pt.align_batch(qs, ss, "local", sc, mesh=mesh)

    def batched(alns):
        h = hashlib.sha256()
        for a in alns:
            h.update(repr((a.score, a.start)).encode() + a.query_aligned
                     + a.subject_aligned)
        return [sum(a.score for a in alns), h.hexdigest()]

    big, mid = len(q1) * len(s1), len(q5) * len(s5)
    calls = [(f"score_pair_sharded 1 Mbp global linear, bands of {rows}",
              big, lambda rows=rows: score(q1, s1, "global", sc, rows), int)
             for rows in PROCESS_BAND_ROWS]
    return calls + [
        ("score_pair_sharded 100k local affine", mid,
         lambda: score(q5, s5, "local", asc), int),
        ("align(mesh=) 100k semiglobal linear", mid,
         lambda: align("semiglobal", sc), lambda a: aligned(a, sc)),
        ("align(mesh=) 100k semiglobal affine", mid,
         lambda: align("semiglobal", asc), lambda a: aligned(a, asc)),
        ("align_batch(mesh=) 10,000 local pairs ~256 bp",
         sum(len(a) * len(b) for a, b in zip(qs, ss)), batch, batched),
    ]


def processes_worker(pid: int, port: int, out_dir: str) -> None:
    """One of phase3_processes's two workers: joins the other through
    torch.distributed, runs every call of the path twice (cold, warm) over
    the mesh of both workers' cuda:0 and writes each call's summary, walls
    and kernel launches to out_dir/worker<pid>.json."""
    from anyseq_tpu_torch.dist import process
    from anyseq_tpu_torch.dist.mesh import init_distributed, make_mesh
    from anyseq_tpu_torch.kernels import _build

    init_distributed(f"127.0.0.1:{port}", 2, pid)
    mesh = make_mesh(devices=[DEVICE + ":0"])
    check(mesh.owner_list() == [0, 1], f"worker {pid}: {mesh}")
    _build.library()
    torch.zeros(1, device=DEVICE).sum().item()
    calls = processes_calls(mesh)
    for k in _build.launches:
        _build.launches[k] = 0
    res = {"mesh": repr(mesh), "calls": {}}
    for name, _, fn, summary in calls:
        walls = []
        for _ in ("cold", "warm"):
            before = dict(_build.launches)
            process.barrier()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        res["calls"][name] = {
            "result": summary(out), "walls_s": walls,
            "launches": {k: v - before[k] for k, v in _build.launches.items()
                         if v > before[k]}}
        print(f"worker {pid}: {name} walls_s={walls}", flush=True)
    res["launches"] = {k: v for k, v in _build.launches.items() if v}
    with open(os.path.join(out_dir, f"worker{pid}.json"), "w") as f:
        json.dump(res, f)


def phase3_processes(counts):
    """The multi-process path: two worker processes (this script with
    --processes-worker), each with a mesh of cuda:0, joined by
    init_distributed on 127.0.0.1, run the calls of processes_calls at full
    size; every worker's results must equal the other's and the single
    device's (run here first, cold then warm). Prints each call's walls
    (the two processes time-slice the card: the walls measure the
    hand-off and its overhead) and the kernels each worker launched; the
    path's kernels must have launched in both. A worker that fails or
    passes PROCESS_TIMEOUT_S fails the phase (both are stopped)."""
    import socket
    import tempfile

    calls = processes_calls(None)
    single = {}
    for name, cells, fn, summary in calls:
        walls = []
        for _ in ("cold", "warm"):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        single[name] = summary(out)
        print(f"phase3 processes single device {name} cells={cells} "
              f"walls_s={[round(w, 4) for w in walls]} "
              f"result={json.dumps(single[name])}", flush=True)
    torch.cuda.empty_cache()
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    with tempfile.TemporaryDirectory() as out_dir:
        logs = [open(os.path.join(out_dir, f"worker{pid}.log"), "w+")
                for pid in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__),
             "--processes-worker", str(pid), str(port), out_dir],
            stdout=logs[pid], stderr=subprocess.STDOUT, cwd=ROOT)
            for pid in range(2)]
        # until both end, one fails (the other would wait on it) or the
        # limit passes
        deadline = time.perf_counter() + PROCESS_TIMEOUT_S
        try:
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.perf_counter() < deadline):
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for pid, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            text = log.read()
            log.close()
            check(p.returncode == 0,
                  f"worker {pid} exited {p.returncode} within "
                  f"{PROCESS_TIMEOUT_S} s:\n{text[-4000:]}")
            with open(os.path.join(out_dir, f"worker{pid}.json")) as f:
                outs.append(json.load(f))
    print(f"phase3 processes: 2 workers, mesh {outs[0]['mesh']}",
          flush=True)
    for name, cells, _, _ in calls:
        got = [w["calls"][name] for w in outs]
        for pid, g in enumerate(got):
            print(f"phase3 processes worker {pid} {name} cells={cells} "
                  f"walls_s={[round(x, 4) for x in g['walls_s']]} "
                  f"gcups_warm={cells / g['walls_s'][1] / 1e9:.2f} "
                  f"launches={json.dumps(g['launches'])}", flush=True)
        check(got[0]["result"] == got[1]["result"] == json.loads(
            json.dumps(single[name])), f"processes: {name}: both workers "
            f"{got[0]['result']} / {got[1]['result']} == the single device "
            f"{single[name]}")
        if isinstance(single[name], list) and len(single[name]) == 4:
            check(single[name][3] == single[name][0],
                  f"processes: {name} rescored {single[name][3]} == score "
                  f"{single[name][0]}")
    path = [k for k, v in KERNELS.items() if "processes" in v[2].split()]
    for pid, w in enumerate(outs):
        for k in path:
            check(w["launches"].get(k, 0) > 0,
                  f"worker {pid} launched {k} ({w['launches']})")
            counts[k] = counts.get(k, 0) + w["launches"][k]
    print(f"phase3 processes: all {len(calls)} calls equal in both workers "
          "and to the single device", flush=True)


def cut_collective(fn, args, rows: int):
    """A kept K10 (or K10 affine) launch cut to its first `rows` rows: the
    band's rows and its explicit left columns (the first rank's)."""
    args = list(args)
    for i in ((1, 5) if fn == "band_collective" else (1, 6, 7)):
        if args[i] is not None:
            args[i] = args[i][:rows]
    return tuple(args)


def phase4_mesh(kept, timings, errors, sm_clock_mhz):
    """K10 and K10 affine on the first band of the mesh path's 4.6 Mbp
    linear and 1 Mbp local affine scores: each rank's whole launch
    replayed alone (its halo already published) with its time and bound,
    then each rank's launch cut to CUT_ROWS rows against its plain
    version (the last rank's times go to the JSON line, for the halo it
    reads); and each score's wall beside the sum of its launches'
    bounds."""
    for call, fn in (("score_pair_sharded 4.6 Mbp global linear",
                      "band_collective"),
                     ("score_pair_sharded 1 Mbp local affine",
                      "band_collective_affine")):
        launches = [args for c, f, args in kept if c == call and f == fn]
        first = [args for args in launches if args[-1] == 0]     # i0 == 0
        # whole bands first: a cut replay publishes fewer halo rows
        for rank, args in enumerate(first):
            ms = cuda_ms(lambda: launcher(fn)(*args), 1)
            b_ms, by = bound(fn, args, sm_clock_mhz)
            h, n = args[1].numel(), args[2].numel()
            print(f"phase4 {fn} alone {call} rank {rank} first band "
                  f"{h}x{n} kernel_ms={ms:.3f} "
                  f"grid={band_grid(fn, h, n, args[-6])} "
                  f"gcups={h * n / ms / 1e6:.2f} bound_ms={b_ms:.3f} "
                  f"bound_by={by} share={b_ms / ms:.3f}", flush=True)
        for rank, args in enumerate(first):
            cut = cut_collective(fn, args, CUT_ROWS)
            err, ms, plain_ms = compare(
                f"phase4 K10 {fn} {call} rank {rank} first band "
                f"{CUT_ROWS}x{cut[2].numel()}", lambda: launcher(fn)(*cut),
                lambda: plain_of(fn, cut), reps=3)
            errors[fn] = max(errors.get(fn, 0), err)
            timings[fn] = (ms, plain_ms, *bound(fn, cut, sm_clock_mhz))
        b_s = sum(bound(fn, args, sm_clock_mhz)[0] for args in launches) / 1e3
        wall = MESH_WALLS[call]
        print(f"phase4 {fn} {call}: {len(launches)} launches bound_s="
              f"{b_s:.4f} wall_s={wall:.4f} share={b_s / wall:.3f}",
              flush=True)


def chained_cuts(fn, args, rows: int):
    """The K8 (or K8 affine) band of `args` run as a chain of bands of
    `rows` rows, each from the bottom row (+ F row) of the one above: the
    outputs of the one launch, merged as ``band.score_pair_chained``
    merges them."""
    affine = fn == "band_affine"
    if affine:
        lib, q, s, row, rowf, corner, col, cole, mode, sc = args
    else:
        lib, q, s, row, corner, col, mode, sc = args
    cols, cols_e, best = [], [], None
    for i0 in range(0, q.numel(), rows):
        cut = slice(i0, i0 + rows)
        top = corner if i0 == 0 else int(col[i0 - 1])
        if affine:
            out = launcher(fn)(lib, q[cut], s, row, rowf, top, col[cut],
                               cole[cut], mode, sc)
            rowf = out["last_row_f"]
            cols_e.append(out["last_col_e"])
        else:
            out = launcher(fn)(lib, q[cut], s, row, top, col[cut], mode, sc)
        row = out["last_row"]
        cols.append(out["last_col"])
        b = out["best"] + torch.tensor([0, i0, 0], dtype=torch.int32,
                                       device=s.device)
        if best is None or int(b[0]) > int(best[0]):
            best = b
    res = {"last_row": row, "last_col": torch.cat(cols), "best": best}
    if affine:
        res.update(last_row_f=rowf, last_col_e=torch.cat(cols_e))
    return res


def phase4_band(kept, timings, errors, whole, sm_clock_mhz):
    """K8 and K8 affine against their plain versions on the first band of
    the 1 Mbp genome scores, cut to CUT_ROWS rows (the times reported in
    the JSON line); each whole 1 Mbp band against itself run as a chain
    of CUT_ROWS-row bands; then the first whole band of the 1 Mbp scores
    and of the 4.6 Mbp global score alone, the kernel's time (the median
    of 3, with their spread and its grid) and its bound (the 1 Mbp ones
    into `whole`, for the JSON line)."""
    score_1 = ("align_score", GENOME_BP, "global", "LinearScoring")
    score_2 = ("align_score", GENOME_BP, "local", "AffineScoring")
    ecoli_6 = ("align_score", ECOLI_BP, "global", "LinearScoring")

    def first_band(call, fn):
        return next(args for c, f, args in kept if c == call and f == fn)

    for call, fn, tag in ((score_1, "band", "K8"),
                          (score_2, "band_affine", "K8 affine")):
        args = list(first_band(call, fn))
        # the band's rows and its left columns (H, and affine E), cut
        for i in ((1, 5) if fn == "band" else (1, 6, 7)):
            args[i] = args[i][:CUT_ROWS]
        cut = tuple(args)
        s = cut[2]
        label = (f"phase4 {tag} {fn} {' '.join(map(str, call))} "
                 f"{CUT_ROWS}x{s.numel()}")
        err, ms, plain_ms = compare(label, lambda: launcher(fn)(*cut),
                                    lambda: plain_of(fn, cut), reps=3)
        errors[fn] = max(errors.get(fn, 0), err)
        timings[fn] = (ms, plain_ms, *bound(fn, cut, sm_clock_mhz))
    for call, fn in ((score_1, "band"), (score_2, "band_affine")):
        args = first_band(call, fn)
        err = max_abs_err(launcher(fn)(*args),
                          chained_cuts(fn, args, CUT_ROWS))
        check(err == 0, f"{fn} {call}: whole band == chained cuts")
        print(f"phase4 {fn} {' '.join(map(str, call))} whole band "
              f"{args[1].numel()}x{args[2].numel()} == a chain of "
              f"{-(-args[1].numel() // CUT_ROWS)} bands of {CUT_ROWS} rows",
              flush=True)
    for call, fn in ((score_1, "band"), (score_2, "band_affine"),
                     (ecoli_6, "band")):
        args = first_band(call, fn)
        runs = [cuda_ms(lambda: launcher(fn)(*args), 1) for _ in range(3)]
        ms = float(np.median(runs))
        cells = args[1].numel() * args[2].numel()
        b_ms, by = bound(fn, args, sm_clock_mhz)
        grid = band_grid(fn, args[1].numel(), args[2].numel(), args[-2])
        print(f"phase4 {fn} alone {' '.join(map(str, call))} first band "
              f"{args[1].numel()}x{args[2].numel()} kernel_ms={ms:.3f} "
              f"runs_ms={[round(r, 3) for r in runs]} "
              f"spread={(max(runs) - min(runs)) / ms:.3f} grid={grid} "
              f"gcups={cells / ms / 1e6:.2f} bound_ms={b_ms:.3f} "
              f"bound_by={by} share={b_ms / ms:.3f}", flush=True)
        if call is not ecoli_6:
            whole[fn] = (f"{args[1].numel()}x{args[2].numel()}", ms, b_ms)
    # each whole chained score: the sum of its bands' bounds beside its wall
    for call, fn in ((score_1, "band"), (score_2, "band_affine"),
                     (ecoli_6, "band")):
        b_s = sum(bound(fn, args, sm_clock_mhz)[0]
                  for c, f, args in kept if c == call and f == fn) / 1e3
        wall = GENOME_WALLS[call]
        print(f"phase4 {fn} chain {' '.join(map(str, call))}: bound_s="
              f"{b_s:.4f} wall_s={wall:.4f} share={b_s / wall:.3f}",
              flush=True)


def phase4(kept, timings, errors, sm_clock_mhz):
    """Each kernel against its plain version on inputs the main paths gave
    it in phase 3. The times reported in the JSON line are these: K1 at
    the 100k local score, K2 and K3 at the linear 10k full traceback, K4
    at the first batched level of the 100k construction; K5 at the
    smallest half sweep of the affine 100k construction, K5p and K6 at the
    affine 10k full traceback, K5L at the first batched level of the
    affine 100k construction; K7 at the largest chunk of the 10,000-pair
    local linear ``align_scores_batch`` (score-only) and
    ``align_batch`` (with codes)."""
    from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
    from anyseq_tpu_torch.kernels import _build

    def kept_of(call, fn, pred=lambda args: True):
        return [args for c, f, args in kept if c == call and f == fn
                and pred(args)]

    def cells(args):
        return args[1].numel() * args[2].numel()

    def shape(fn, args):
        if fn.startswith("wavefront"):
            return f"{args[1].numel()}x{args[2].numel()}"
        if fn.startswith("walk"):
            words, q, s = args[1:4]
            return f"B={words.shape[0]} {q.shape[1]}x{s.shape[1]}"
        q, s, ms, ns = args[1:5]
        return f"B={q.shape[0]} up to {int(ms.max())}x{int(ns.max())}"

    def geometry(tag, name, call, fn, args, ms):
        """A K1 / K5 launch's width and warps, bound and share; K2 / K5p's
        also with the kernel's device time (torch.profiler) and its
        share."""
        m, n = args[1].numel(), args[2].numel()
        affine = fn == "wavefront_affine"
        width, grid = sweep_geometry(affine, m, n, args[3],
                                     codes=preds(args))
        b_ms, by = bound(fn, args, sm_clock_mhz)
        device = ""
        if preds(args):
            dev_ms = device_ms(lambda: launcher(fn)(*args),
                               "band_affine_kernel" if affine
                               else "band_kernel")
            device = (f" device_ms={dev_ms:.4f} device_share="
                      f"{b_ms / dev_ms:.3f}" if dev_ms
                      else " device_ms=not measured")
        print(f"phase4 {tag} {name} {' '.join(map(str, call))} {m}x{n} "
              f"width={width} grid={grid} kernel_ms={ms:.3f} "
              f"gcups={m * n / ms / 1e6:.2f} bound_ms={b_ms:.3f} "
              f"bound_by={by} share={b_ms / ms:.3f}{device}", flush=True)

    def run(name, tag, call, fn, args, report=False):
        label = f"phase4 {tag} {name} {' '.join(map(str, call))} " \
                f"{shape(fn, args)}"
        err, ms, plain_ms = compare(label, lambda: launcher(fn)(*args),
                                    lambda: plain_of(fn, args), reps=3)
        errors[name] = max(errors.get(name, 0), err)
        if report:
            timings[name] = (ms, plain_ms, *bound(fn, args, sm_clock_mhz))
        if fn.startswith("wavefront"):
            geometry(tag, name, call, fn, args, ms)
        if fn.startswith("walk"):
            walk_bound(label, fn, args, ms)
        return ms

    def walk_bound(label, fn, args, ms):
        """A walk launch's time beside its bound, kind and share."""
        b_ms, by = bound(fn, args, sm_clock_mhz)
        live, inside = walk_steps(launcher(fn)(*args))
        print(f"{label} walks={int((live > 0).sum())} longest_steps="
              f"{int(live.max())} chain_steps={int(inside.max())} "
              f"kernel_ms={ms:.4f} bound_ms={b_ms:.4f} "
              f"bound_by={by} share={b_ms / ms:.3f}", flush=True)

    def alone(name, tag, call, fn, args):
        """A K1 / K5 launch timed alone: the plain version would take
        minutes there."""
        ms = cuda_ms(lambda: launcher(fn)(*args), 3)
        geometry(f"{tag} alone", name, call, fn, args, ms)

    def preds(args):
        return args[5]

    def levels(name, tag, call, launches):
        """Every K4 / K5L launch of `call` (a level each) against its plain
        version at the rule's width and at each width, each timed alone,
        with the rule's width, warps, boundary scratch, its cap and the
        critical path; the first level's time at the rule's width is the
        JSON line's."""
        from anyseq_tpu_torch.kernels import lastcols

        affine = name == "lastcols_affine"
        widths = lastcols.AFFINE_WIDTHS if affine else lastcols.WIDTHS
        fn, total = launcher(name), 0.0
        for idx, args in enumerate(launches):
            ms_, ns_ = args[3:5]
            want, plain_ms = timed(lambda: plain_of(name, args))
            times = {}
            for w in (0, *widths):
                err = max_abs_err(fn(*args, width=w), want)
                if w == 0:
                    plan = lastcols.last_plan
                check(err == 0, f"phase4 {tag} {name} launch {idx} width "
                                f"{w or 'rule'}: kernel == plain "
                                f"(max_abs_err {err})")
                errors[name] = max(errors.get(name, 0), err)
                times[w] = cuda_ms(lambda: fn(*args, width=w), 3)
            b_ms, by = bound(name, args, sm_clock_mhz)
            total += times[0]
            print(f"phase4 {tag} {name} {' '.join(map(str, call))} launch "
                  f"{idx} B={len(ms_)} up to {int(max(ms_))}x"
                  f"{int(max(ns_))} equal=True width={plan.width} "
                  f"warps={plan.warps} scratch_bytes={plan.scratch_bytes} "
                  f"cap_bytes={plan.cap_bytes} path_steps="
                  f"{level_path_steps(affine, ms_, ns_, plan.width)} "
                  f"kernel_ms={times[0]:.3f} bound_ms={b_ms:.3f} "
                  f"bound_by={by} share={b_ms / times[0]:.3f} "
                  f"plain_ms={plain_ms:.1f} widths_ms="
                  f"{json.dumps({w: round(times[w], 3) for w in widths})}",
                  flush=True)
            if idx == 0:
                timings[name] = (times[0], plain_ms, b_ms, by)
        print(f"phase4 {tag} {name} {' '.join(map(str, call))}: "
              f"{len(launches)} launches kernel_ms_total={total:.3f}",
              flush=True)

    score_1k = ("align_score", 1000, "global", "LinearScoring")
    fulltb = ("align_full_tb", 10_000, "local", "LinearScoring")
    score_100k = ("align_score", 100_000, "local", "LinearScoring")
    hb = ("align", 100_000, "semiglobal", "LinearScoring")
    a_fulltb = ("align_full_tb", 10_000, "global", "AffineScoring")
    mm = ("align", 100_000, "semiglobal", "AffineScoring")
    k1_hb = sorted(kept_of(hb, "wavefront", lambda a: not preds(a)),
                   key=cells)
    k3_hb = max(kept_of(hb, "walk"), key=lambda args: args[1].shape[0])
    k4_hb = kept_of(hb, "lastcols")
    run("wavefront_score", "K1", score_1k, "wavefront",
        kept_of(score_1k, "wavefront")[0])
    run("wavefront_score", "K1", score_100k, "wavefront",
        kept_of(score_100k, "wavefront")[0], report=True)
    run("wavefront_score", "K1", hb, "wavefront", k1_hb[0])
    alone("wavefront_score", "K1", hb, "wavefront", k1_hb[-1])
    run("wavefront_preds", "K2", fulltb, "wavefront",
        kept_of(fulltb, "wavefront")[0], report=True)
    run("walk", "K3", fulltb, "walk", kept_of(fulltb, "walk")[0],
        report=True)
    run("walk", "K3", hb, "walk", k3_hb)
    levels("lastcols", "K4", hb, k4_hb)

    k5_mm = sorted(kept_of(mm, "wavefront_affine", lambda a: not preds(a)),
                   key=cells)
    k6_mm = max(kept_of(mm, "walk_affine"), key=lambda args: args[1].shape[0])
    k5l_mm = kept_of(mm, "lastcols_affine")
    run("wavefront_affine_score", "K5", mm, "wavefront_affine", k5_mm[0],
        report=True)
    alone("wavefront_affine_score", "K5", mm, "wavefront_affine", k5_mm[-1])
    run("wavefront_affine_preds", "K5p", a_fulltb, "wavefront_affine",
        kept_of(a_fulltb, "wavefront_affine", preds)[0], report=True)
    run("walk_affine", "K6", a_fulltb, "walk_affine",
        kept_of(a_fulltb, "walk_affine")[0], report=True)
    run("walk_affine", "K6", mm, "walk_affine", k6_mm)
    levels("lastcols_affine", "K5L", mm, k5l_mm)
    # K2 and K5p alone at the `auto` cap (2,048 x 2,048) and at the batch
    # calls' ~256 bp, local (a generator of its own)
    rng = np.random.default_rng(SEED + 13)
    for size in (2048, 256):
        qb, sb = related_pair(rng, size)
        sb = (sb + related_pair(rng, size)[0])[:size]
        q, s = (torch.frombuffer(bytearray(x), dtype=torch.uint8).cuda()
                for x in (qb, sb))
        for scoring in (LinearScoring(), AffineScoring(*AFFINE)):
            affine = isinstance(scoring, AffineScoring)
            args = ((_build.library(), q, s, Mode.LOCAL, scoring, True)
                    + ((False, False) if affine else ()))
            run("wavefront_affine_preds" if affine else "wavefront_preds",
                "K5p" if affine else "K2",
                ("alone", size, "local", type(scoring).__name__),
                "wavefront_affine" if affine else "wavefront", args)

    a_score_100k = ("align_score", 100_000, "local", "AffineScoring")
    alone("wavefront_affine_score", "K5", a_score_100k, "wavefront_affine",
          kept_of(a_score_100k, "wavefront_affine")[0])

    def largest(call, fn):
        return max(kept_of(call, fn), key=lambda args: args[1].shape[0])

    def k7(call, args, report=False):
        """A K7 launch against its plain version, with its width, warps,
        strips, boundary scratch, bound and share."""
        from anyseq_tpu_torch.kernels import swarm

        name = "swarm_preds" if args[9] else "swarm_score"
        ms = run(name, "K7", call, "swarm", args, report=report)
        plan = swarm.last_plan
        b_ms, by = bound("swarm", args, sm_clock_mhz)
        print(f"phase4 K7 {name} {' '.join(map(str, call))} "
              f"{shape('swarm', args)} width={plan.width} "
              f"warps={plan.warps} strips={plan.strips} scratch_bytes="
              f"{plan.scratch_bytes} kernel_ms={ms:.4f} bound_ms={b_ms:.4f} "
              f"bound_by={by} share={b_ms / ms:.3f}", flush=True)

    scores_10k = ("align_scores_batch", 256, 10_000, "local",
                  "LinearScoring")
    aln_10k = ("align_batch", 256, 10_000, "local", "LinearScoring")
    # the 10k local score's launches (its cold and warm calls each made
    # them): its (256, 256) and (256, 512) buckets, the larger reported
    buckets: dict = {}
    for args in kept_of(scores_10k, "swarm"):
        buckets.setdefault((args[1].shape, args[2].shape), args)
    for args in sorted(buckets.values(), key=lambda a: -a[1].shape[0]):
        k7(scores_10k, args, report=args is largest(scores_10k, "swarm"))
    k7(aln_10k, largest(aln_10k, "swarm"), report=True)
    run("walk", "K3", aln_10k, "walk", largest(aln_10k, "walk"))
    # phase 2's ~2000 x 3000 walks (compared there), timed alone
    for name, tag, case, args in WALK_SHAPES:
        walk_bound(f"phase4 {tag} {name} {case}", name, args,
                   cuda_ms(lambda: launcher(name)(*args), 5))
    for call in (("align_scores_batch", 256, 10_000, "local",
                  "AffineScoring"),
                 ("align_batch", 256, 1000, "semiglobal", "LinearScoring"),
                 ("align_scores_batch", 4096, 200, "local",
                  "LinearScoring")):
        k7(call, largest(call, "swarm"))


def check_level_plans():
    """Every K4 / K5L launch of phase 3 kept its boundary columns within
    the level rule's cap; the largest of each call, beside the cap."""
    check(LEVEL_PLANS, "phase 3 launched K4 / K5L")
    largest: dict = {}
    for call, fn, plan in LEVEL_PLANS:
        check(plan.scratch_bytes <= plan.cap_bytes,
              f"{fn} in {' '.join(map(str, call))} at width {plan.width}: "
              f"scratch {plan.scratch_bytes} <= cap {plan.cap_bytes}")
        key = (" ".join(map(str, call)), fn)
        if plan.scratch_bytes >= largest.get(key, (0, None))[0]:
            largest[key] = (plan.scratch_bytes, plan)
    for (call, fn), (_, plan) in largest.items():
        print(f"phase4 level scratch {call} {fn}: largest "
              f"scratch_gb={plan.scratch_bytes / 1e9:.3f} at width "
              f"{plan.width} ({plan.warps} warps), cap_gb="
              f"{plan.cap_bytes / 1e9:.3f}", flush=True)
    print(f"phase4 level scratch: all {len(LEVEL_PLANS)} K4 / K5L launches "
          f"within the rule's cap", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--processes-worker"]:
        processes_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if not os.path.isdir(os.path.join(ROOT, "anyseq_tpu_torch", "kernels",
                                      "csrc")):
        print("chip_smoke: no anyseq_tpu_torch/ beside this script",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[torch.cuda.current_device()]
    sm_clock_mhz = sm_clock_of()
    print(f"phase1 card: {smi}, max SM clock {sm_clock_mhz:.0f} MHz",
          flush=True)

    from anyseq_tpu_torch.kernels import _build

    report = build_report()
    build = _build.build()
    print(f"phase1 build: {build.path.name} in {build.seconds:.1f}s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)
    report()

    rng = np.random.default_rng(SEED)
    timings, errors, kept, whole = {}, {}, [], {}
    t_start = time.perf_counter()

    def elapsed(what):
        """The run's time so far, after `what` (the 1200 s budget)."""
        print(f"elapsed after {what}: {time.perf_counter() - t_start:.1f}s",
              flush=True)

    phase2(rng, errors)
    # its own generator: the later phases' seeded pairs stay as they were
    phase2_walks(np.random.default_rng(SEED + 10), errors)
    phase2_sweeps(errors)
    phase2_code_sweeps(errors)
    phase2_levels(errors)
    phase2_band(rng, errors)
    phase2_collective(rng, errors)
    phase2_swarm_affine_codes(rng, errors)
    # its own generator, as phase2_walks'
    phase2_swarm(np.random.default_rng(SEED + 11), errors)
    elapsed("phase 2")
    counts = phase3(rng, kept)
    phase3_batch(rng, kept, counts)
    phase3_small(rng)
    elapsed("phase 3's single-pair, batch and small paths")
    phase3_genome(rng, kept, counts)
    elapsed("phase 3's genome path")
    phase3_mesh(rng, kept, counts)
    elapsed("phase 3's mesh path")
    phase3_processes(counts)
    elapsed("phase 3's multi-process path")
    phase4(kept, timings, errors, sm_clock_mhz)
    check_level_plans()
    phase4_band(kept, timings, errors, whole, sm_clock_mhz)
    phase4_mesh(kept, timings, errors, sm_clock_mhz)
    elapsed("phase 4")

    # no PyTorch call computes a DP alignment or a traceback walk, so no
    # kernel has a library yardstick; K8's times are at a cut of a band,
    # and beside them its time at a whole 1 Mbp band
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": errors[name],
         "ms": round(timings[name][0], 4),
         "plain_ms": round(timings[name][1], 2),
         "bound_ms": round(timings[name][2], 6),
         "bound_by": timings[name][3], "library_ms": None}
        for name, (src, rep, _) in KERNELS.items()
    ]
    for k in kernels:
        if k["name"] in REDESIGNED:
            k.update(redesigned=True, core=REDESIGNED[k["name"]])
        if k["name"] in whole:
            shape, ms, b_ms = whole[k["name"]]
            k.update(whole_band=shape, whole_band_ms=round(ms, 4),
                     whole_band_bound_ms=round(b_ms, 6))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
