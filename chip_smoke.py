#!/usr/bin/env python3
"""Drive anyseq_tpu_torch's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a non-zero exit code):

1. Device and build: the card's name and power limit (nvidia-smi), and the
   nvcc build of the kernels from ``anyseq_tpu_torch/kernels/csrc/``.
2. Each kernel against its plain torch version on the card, on the same
   tensors, bit for bit (integer DP: the tolerance is zero), with both
   times: linear scoring 2/-1/-1 and affine scoring 2/-1/-3/-1.
3. The main path through the public API with ``device="cuda"``, linear:
   ``align_score`` 1k global, ``align_full_tb`` 10k local, ``align_score``
   100k local and ``align`` 100k semiglobal (which ``traceback="auto"``
   sends to Hirschberg); affine: ``align_score`` 100k local,
   ``align_full_tb`` 10k global and ``align`` 100k semiglobal (Myers-Miller);
   each with its wall time, GCUPS and kernel launches. The launch counts
   are set to 0 before each of the two paths and read after it: every
   kernel of the path must have launched. Both 100k alignments are
   rescored from their strings and must equal their score and
   ``align_score``. Small inputs (the golden corpus and a random pair,
   both schemes) must give the same results on the card as the plain
   versions on the CPU.
4. Each kernel against its plain version again, on the very inputs the
   main path gave it in phase 3 (kept as they passed), bit for bit.
5. A JSON line of the kernels, the card's line, and the final JSON line.

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
    # name: (source, the TPU kernel it replaces, the main path that runs it)
    "wavefront_score": ("anyseq_tpu_torch/kernels/csrc/wavefront.cu",
                        "anyseq_tpu/kernels/band.py:1336", "linear"),
    "wavefront_preds": ("anyseq_tpu_torch/kernels/csrc/wavefront.cu",
                        "anyseq_tpu/kernels/band.py:1336", "linear"),
    "walk": ("anyseq_tpu_torch/kernels/csrc/walk.cu",
             "anyseq_tpu/engine/device_tb.py:405", "linear"),
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
}
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
    from anyseq_tpu_torch.kernels import lastcols, walk, wavefront

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


# The launch function of each kernel wrapper module (K1/K2 share one, as
# do K5/K5p); the plain version takes the same arguments after the library.
LAUNCHERS = {
    "wavefront": ("wavefront", "launch"),
    "wavefront_affine": ("wavefront", "launch_affine"),
    "walk": ("walk", "launch"),
    "walk_affine": ("walk", "launch_affine"),
    "lastcols": ("lastcols", "launch"),
    "lastcols_affine": ("lastcols", "launch_affine"),
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


def phase3(rng, kept):
    """The main path through the public API, one path per gap scheme, each
    driven with every launch count set to 0 just before it and read just
    after; returns each kernel's count from the path that runs it."""
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
            for k, v in _build.launches.items():
                if KERNELS[k][2] == path:
                    counts[k] = v
                    check(v > 0, f"kernel {k} launched on the {path} main "
                          f"path ({v})")

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
    print(f"phase3 small inputs: card == CPU plain, {checked} golden checks "
          f"equal", flush=True)


def phase4(kept, timings, errors):
    """Each kernel against its plain version on inputs the main path gave
    it in phase 3. The times reported in the JSON line are these: K1 at
    the 100k local score, K2 and K3 at the linear 10k full traceback, K4
    at the first batched level of the 100k construction; K5 at the
    smallest half sweep of the affine 100k construction, K5p and K6 at the
    affine 10k full traceback, K5L at the first batched level of the
    affine 100k construction."""

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
            timings[name] = (ms, plain_ms)

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
    print(f"phase1 card: {smi}", flush=True)

    from anyseq_tpu_torch.kernels import _build

    build = _build.build()
    print(f"phase1 build: {build.path.name} in {build.seconds:.1f}s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)

    rng = np.random.default_rng(SEED)
    timings, errors, kept = {}, {}, []
    phase2(rng, errors)
    counts = phase3(rng, kept)
    phase3_small(rng)
    phase4(kept, timings, errors)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": errors[name],
         "ms": round(timings[name][0], 4),
         "plain_ms": round(timings[name][1], 2)}
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
