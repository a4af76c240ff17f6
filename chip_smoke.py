#!/usr/bin/env python3
"""Drive anyseq_tpu_torch's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a non-zero exit code):

1. Device and build: the card's name, power limit and top SM clock
   (nvidia-smi), and the nvcc build of the kernels from
   ``anyseq_tpu_torch/kernels/csrc/``.
2. Each kernel against its plain torch version on the card, on the same
   tensors, bit for bit (integer DP: the tolerance is zero), with both
   times: linear scoring 2/-1/-1 and affine scoring 2/-1/-3/-1.
3. Three main paths through the public API with ``device="cuda"``, each
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
   CPU.
4. Each kernel against its plain version again, on the very inputs the
   main paths gave it in phase 3 (kept as they passed), bit for bit.
5. A JSON line of the kernels (with each one's bound: the larger of the
   bytes it must move over 3.35 TB/s and its int32 operations over 132
   SMs x 64 int32 lanes x the top SM clock), the card's line, and the
   final JSON line.

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
    "wavefront_score": ("anyseq_tpu_torch/kernels/csrc/wavefront.cu",
                        "anyseq_tpu/kernels/band.py:1336", "linear"),
    "wavefront_preds": ("anyseq_tpu_torch/kernels/csrc/wavefront.cu",
                        "anyseq_tpu/kernels/band.py:1336", "linear"),
    "walk": ("anyseq_tpu_torch/kernels/csrc/walk.cu",
             "anyseq_tpu/engine/device_tb.py:405", "linear batch"),
    "lastcols": ("anyseq_tpu_torch/kernels/csrc/lastcols.cu",
                 "anyseq_tpu/kernels/band.py:1677", "linear"),
    "wavefront_affine_score": (
        "anyseq_tpu_torch/kernels/csrc/wavefront_affine.cu",
        "anyseq_tpu/kernels/band.py:1336", "affine"),
    "wavefront_affine_preds": (
        "anyseq_tpu_torch/kernels/csrc/wavefront_affine.cu",
        "anyseq_tpu/kernels/band.py:1336", "affine"),
    "lastcols_affine": ("anyseq_tpu_torch/kernels/csrc/lastcols_affine.cu",
                        "anyseq_tpu/kernels/band.py:1677", "affine"),
    "walk_affine": ("anyseq_tpu_torch/kernels/csrc/walk_affine.cu",
                    "anyseq_tpu/engine/device_tb.py:352", "affine"),
    "swarm_score": ("anyseq_tpu_torch/kernels/csrc/swarm.cu",
                    "anyseq_tpu/kernels/swarm.py:318", "batch"),
    "swarm_preds": ("anyseq_tpu_torch/kernels/csrc/swarm.cu",
                    "anyseq_tpu/kernels/swarm.py:318", "batch"),
}
# int32 operations a cell (or a walk step) of each kernel, counted from
# its plain recurrence: linear H = max(diag + sub, max(up, left) + gap)
# with sub a compare and a select (6); Gotoh F, E (two adds and a max
# each), T and H (11); 2-bit codes add three compares, a shift and an or
# (5), 4-bit codes nine; a walk step decodes its code (shift, and), takes
# three compares and two decrements and forms its address (8).
OPS = {"wavefront": 6, "wavefront_affine": 11, "lastcols": 6,
       "lastcols_affine": 11, "swarm": 6, "swarm_affine": 11,
       "codes": 5, "codes4": 9, "walk": 8, "walk_affine": 8}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT32_LANES_PER_SM = 64
# the affine scoring of the JAX package's bench suite (bench/suite.py)
AFFINE = (2, -1, -3, -1)


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
    from anyseq_tpu_torch.kernels import lastcols, swarm, walk, wavefront

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
    return getattr(mod, "plain_affine" if fn.endswith("_affine")
                   else "plain")(*args[1:])


@contextlib.contextmanager
def kept_launches(kept: list, call: list):
    """Keep (call[0], launcher, arguments) of every kernel launch made
    inside the block; `call[0]` names the public call being driven."""
    real = {fn: launcher(fn) for fn in LAUNCHERS}

    def keeping(fn):
        def launch(*args):
            kept.append((call[0], fn, args))
            return real[fn](*args)
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


def bound(fn: str, args, sm_clock_mhz: float):
    """(bound_ms, bound_by) of one launch of `fn` on `args`: the larger of
    the bytes it must move (each input read once, each output written
    once) over the card's memory rate and its int32 operations (OPS a cell
    or a walk step) over 132 SMs x 64 int32 lanes x the top SM clock. A
    walk counts the steps this run's data takes (the positions it
    writes)."""
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
        ops = m * n * (OPS[fn] + (OPS["codes4" if affine else "codes"]
                                  if preds else 0))
    elif fn.startswith("walk"):
        out_q = launcher(fn)(*args)[0]
        steps = int((out_q != ord(" ")).sum())
        nbytes = steps * (4 + 2 + 2) + 16 * out_q.shape[0]
        ops = steps * OPS[fn]
    else:
        q, s, ms, ns = args[1:5]
        ms, ns = ms.to(torch.int64), ns.to(torch.int64)
        cells = int((ms * ns).sum())
        B, sum_m, sum_n = q.shape[0], int(ms.sum()), int(ns.sum())
        nbytes = sum_m + sum_n + 8 * B
        if fn.startswith("lastcols"):
            affine = fn == "lastcols_affine"
            nbytes += 4 * sum_m * (2 if affine else 1) + (B if affine else 0)
            ops = cells * OPS[fn]
        else:
            sc, sgaps, _, preds = args[6:10]
            affine = hasattr(sc, "gap_open")
            nbytes += B + 4 * (sum_m + sum_n) + 12 * B
            if preds:
                nbytes += 4 * int((ms * ((ns + 15) // 16)).sum())
            ops = cells * (OPS["swarm_affine" if affine else "swarm"]
                           + (OPS["codes"] if preds else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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

    def run(name, tag, call, fn, args, report=False):
        label = f"phase4 {tag} {name} {' '.join(map(str, call))} " \
                f"{shape(fn, args)}"
        err, ms, plain_ms = compare(label, lambda: launcher(fn)(*args),
                                    lambda: plain_of(fn, args), reps=3)
        errors[name] = max(errors.get(name, 0), err)
        if report:
            timings[name] = (ms, plain_ms, *bound(fn, args, sm_clock_mhz))

    def preds(args):
        return args[5]

    score_1k = ("align_score", 1000, "global", "LinearScoring")
    fulltb = ("align_full_tb", 10_000, "local", "LinearScoring")
    score_100k = ("align_score", 100_000, "local", "LinearScoring")
    hb = ("align", 100_000, "semiglobal", "LinearScoring")
    a_fulltb = ("align_full_tb", 10_000, "global", "AffineScoring")
    mm = ("align", 100_000, "semiglobal", "AffineScoring")
    k1_hb = min(kept_of(hb, "wavefront"), key=cells)
    k3_hb = max(kept_of(hb, "walk"), key=lambda args: args[1].shape[0])
    k4_hb = kept_of(hb, "lastcols")
    run("wavefront_score", "K1", score_1k, "wavefront",
        kept_of(score_1k, "wavefront")[0])
    run("wavefront_score", "K1", score_100k, "wavefront",
        kept_of(score_100k, "wavefront")[0], report=True)
    run("wavefront_score", "K1", hb, "wavefront", k1_hb)
    run("wavefront_preds", "K2", fulltb, "wavefront",
        kept_of(fulltb, "wavefront")[0], report=True)
    run("walk", "K3", fulltb, "walk", kept_of(fulltb, "walk")[0],
        report=True)
    run("walk", "K3", hb, "walk", k3_hb)
    run("lastcols", "K4", hb, "lastcols", k4_hb[0], report=True)
    run("lastcols", "K4", hb, "lastcols", k4_hb[-1])

    k5_mm = min(kept_of(mm, "wavefront_affine"), key=cells)
    k6_mm = max(kept_of(mm, "walk_affine"), key=lambda args: args[1].shape[0])
    k5l_mm = kept_of(mm, "lastcols_affine")
    run("wavefront_affine_score", "K5", mm, "wavefront_affine", k5_mm,
        report=True)
    run("wavefront_affine_preds", "K5p", a_fulltb, "wavefront_affine",
        kept_of(a_fulltb, "wavefront_affine", preds)[0], report=True)
    run("walk_affine", "K6", a_fulltb, "walk_affine",
        kept_of(a_fulltb, "walk_affine")[0], report=True)
    run("walk_affine", "K6", mm, "walk_affine", k6_mm)
    run("lastcols_affine", "K5L", mm, "lastcols_affine", k5l_mm[0],
        report=True)
    run("lastcols_affine", "K5L", mm, "lastcols_affine", k5l_mm[-1])

    # K5 alone at the affine 100k local score: the plain version would
    # take minutes there, so only the kernel's time
    args = kept_of(("align_score", 100_000, "local", "AffineScoring"),
                   "wavefront_affine")[0]
    ms = cuda_ms(lambda: launcher("wavefront_affine")(*args), 3)
    print(f"phase4 K5 wavefront_affine_score align_score 100000 local "
          f"AffineScoring {shape('wavefront_affine', args)} "
          f"kernel_ms={ms:.3f} gcups={cells(args) / ms / 1e6:.2f}",
          flush=True)

    def largest(call, fn):
        return max(kept_of(call, fn), key=lambda args: args[1].shape[0])

    scores_10k = ("align_scores_batch", 256, 10_000, "local",
                  "LinearScoring")
    aln_10k = ("align_batch", 256, 10_000, "local", "LinearScoring")
    run("swarm_score", "K7", scores_10k, "swarm",
        largest(scores_10k, "swarm"), report=True)
    run("swarm_preds", "K7", aln_10k, "swarm", largest(aln_10k, "swarm"),
        report=True)
    run("walk", "K3", aln_10k, "walk", largest(aln_10k, "walk"))
    for call in (("align_scores_batch", 256, 10_000, "local",
                  "AffineScoring"),
                 ("align_batch", 256, 1000, "semiglobal", "LinearScoring"),
                 ("align_scores_batch", 4096, 200, "local",
                  "LinearScoring")):
        args = largest(call, "swarm")
        run("swarm_preds" if args[9] else "swarm_score", "K7", call,
            "swarm", args)
        ms_, by = bound("swarm", args, sm_clock_mhz)
        print(f"phase4 K7 bound {' '.join(map(str, call))} "
              f"bound_ms={ms_:.4f} bound_by={by}", flush=True)


def main() -> int:
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
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()
    sm_clock_mhz = float(clock[torch.cuda.current_device()])
    print(f"phase1 card: {smi}, max SM clock {sm_clock_mhz:.0f} MHz",
          flush=True)

    from anyseq_tpu_torch.kernels import _build

    build = _build.build()
    print(f"phase1 build: {build.path.name} in {build.seconds:.1f}s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)

    rng = np.random.default_rng(SEED)
    timings, errors, kept = {}, {}, []
    phase2(rng, errors)
    counts = phase3(rng, kept)
    phase3_batch(rng, kept, counts)
    phase3_small(rng)
    phase4(kept, timings, errors, sm_clock_mhz)

    # no PyTorch call computes a DP alignment or a traceback walk, so no
    # kernel has a library yardstick
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": errors[name],
         "ms": round(timings[name][0], 4),
         "plain_ms": round(timings[name][1], 2),
         "bound_ms": round(timings[name][2], 6),
         "bound_by": timings[name][3], "library_ms": None}
        for name, (src, rep, _) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
