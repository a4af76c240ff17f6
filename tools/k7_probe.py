#!/usr/bin/env python3
"""K7, the batch sweep (``kernels/swarm.py``, ``csrc/swarm.cu``), of two
checkouts on one CUDA card, in turns; and this tree's K7 forced to each
width and built with its codes stored directly, the data behind its width
rule and its staged codes.

    python3 tools/k7_probe.py --parent DIR [--reps 5]

DIR is an unpacked older tree. Each tree (older, this, this, older; each
a process of its own that builds its tree's kernels) drives the public
calls that run K7 -- ``align_scores_batch`` on 10,000 related ~256 bp
pairs (local, linear and affine), ``align_batch`` on them (local) and
``align_scores_batch`` on 200 pairs of ~4,096 bp -- once cold and three
times warm (host walls), then times K7 alone through its own wrapper
(``swarm.launch``, at its own width rule) at the shapes of those calls'
launches (the pairs bucketed by 256 as ``engine/batch.py`` does: the
(256, 256) and (256, 512) buckets, score-only and with codes, the affine
score, the largest 4,096 bp bucket), at 4,096 random problems of up to
256 x 256 with affine codes, and at small problems (129 of up to 17 x
40, 2,000 of 32 x 32, 64 x 64 and 128 x 128) where one thread a problem
may win. The outputs of all runs must be equal. Prints one JSON line a
measurement, then the medians with their spreads (the kernel's device
time, from torch.profiler; beside it the wrapper's call timed with CUDA
events, its host work included, and the host's time from the call to its
return: this tree's wrapper is given the lengths on the host, as the
batch calls give them), and the card's name and power limit.

    python3 tools/k7_probe.py --sweep [--reps 5]

times this tree's K7 at the same shapes forced to each width it has, and
with codes also built (a copy of the sources) with every code segment
stored directly instead of staged in shared memory (band_sweep.cuh
Codes, edited in the copy: STORES); the rule's width, warps and strips
beside each time; outputs held equal.

    python3 tools/k7_probe.py --check

prints ptxas's registers and spills of every K7 instantiation, then holds
K7 to its plain version bit for bit at phase 2's shapes of
``chip_smoke.py`` (``phase2_swarm``).

    python3 tools/k7_probe.py --host [--reps 5]

times this tree's wrapper on the host at the small shapes and the (256,
256) score launch, whole and in parts (``host_parts``). The options
combine in one call.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from _ab import (child, emit, equal_outputs, grouped, host_runs, import_tree,
                 in_turns, smi, stats, timed_runs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2024
AFFINE = (2, -1, -3, -1)
BUCKET = 256          # engine/batch.py _bucket
SCORE_CHUNK = 8192    # engine/batch.py's chunks
ALIGN_CHUNK = 4096


def pair_sets():
    """The public calls' pairs: 10,000 of ~256 bp and 200 of ~4,096 bp."""
    from chip_smoke import related_pair

    rng = np.random.default_rng(SEED + 3)
    short = [related_pair(rng, 256) for _ in range(10_000)]
    long_ = [related_pair(rng, 4096) for _ in range(200)]
    return short, long_


def buckets(pairs, cap: int):
    """{(M, N): the first chunk of at most `cap` pairs} of the pairs
    bucketed by padded shape (engine/batch.py _bucket)."""
    out: dict = {}
    for q, s in pairs:
        key = tuple(max(BUCKET, -(-len(x) // BUCKET) * BUCKET)
                    for x in (q, s))
        if len(out.setdefault(key, [])) < cap:
            out[key].append((q, s))
    return out


def padded(pairs, M: int, N: int, dev):
    """(q, s, ms, ns) on `dev` of pairs padded to M x N (with 'A')."""
    import torch

    def pad(xs, width):
        return torch.from_numpy(np.frombuffer(b"".join(
            (x + b"A" * width)[:width] for x in xs), np.uint8).reshape(
                len(xs), width).copy()).to(dev)

    qs, ss = zip(*pairs)
    lens = [torch.tensor([len(x) for x in xs], device=dev) for xs in (qs, ss)]
    return pad(qs, M), pad(ss, N), *lens


def shapes():
    """[(shape name, launch arguments after the library)] of K7 at the
    public calls' shapes, affine codes and small problems."""
    import torch

    from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode

    sc, asc = LinearScoring(), AffineScoring(*AFFINE)
    dev = torch.device("cuda")
    short, long_ = pair_sets()
    out = []
    for (M, N), pairs in buckets(short, SCORE_CHUNK).items():
        args = padded(pairs, M, N, dev)
        out.append((f"score ({M}, {N}) local", (*args, Mode.LOCAL, sc, None,
                                                False, False)))
        out.append((f"score ({M}, {N}) local affine",
                    (*args, Mode.LOCAL, asc, None, False, False)))
    for (M, N), pairs in buckets(short, ALIGN_CHUNK).items():
        out.append((f"codes ({M}, {N}) local", (*padded(pairs, M, N, dev),
                                                Mode.LOCAL, sc, None, True,
                                                True)))
    (M, N), pairs = max(buckets(long_, SCORE_CHUNK).items(),
                        key=lambda kv: len(kv[1]))
    out.append((f"score ({M}, {N}) local", (*padded(pairs, M, N, dev),
                                            Mode.LOCAL, sc, None, False,
                                            False)))
    rng = np.random.default_rng(SEED + 4)

    def random_batch(B, M, N):
        q = torch.from_numpy(rng.integers(65, 69, (B, M), dtype=np.uint8))
        s = torch.from_numpy(rng.integers(65, 69, (B, N), dtype=np.uint8))
        ms = torch.from_numpy(rng.integers(1, M + 1, B))
        ns = torch.from_numpy(rng.integers(1, N + 1, B))
        return q.to(dev), s.to(dev), ms.to(dev), ns.to(dev)

    sg = torch.from_numpy(rng.integers(0, 2, 4096).astype(bool)).to(dev)
    for mode in Mode:
        out.append((f"affine codes 4096 up to 256x256 {mode.value}",
                    (*random_batch(4096, 256, 256), mode, asc, sg, True,
                     True)))
    for B, M, N in ((129, 17, 40), (2000, 32, 32), (2000, 64, 64),
                    (2000, 128, 128)):
        args = random_batch(B, M, N)
        for preds in (False, True):
            out.append((f"small {B} up to {M}x{N} local preds={preds}",
                        (*args, Mode.LOCAL, sc, None, True, preds)))
    return out


def checksum(out) -> list:
    """Sums of K7's outputs, plain and weighted, to hold runs equal."""
    import torch

    sums = []
    for k in ("last_rows", "last_cols", "best", "preds"):
        if k in out:
            x = out[k].reshape(out[k].shape[0], -1).long()
            w = torch.arange(x.shape[1], device=x.device) % 7 + 1
            sums += [int(x.sum()), int((x * w).sum())]
    return sums


def public_walls(tree: str) -> None:
    """The public calls that run K7, each once cold and three times warm
    (host clock around the call, ending in a synchronize)."""
    import torch

    import anyseq_tpu_torch as pt

    sc, asc = pt.LinearScoring(), pt.AffineScoring(*AFFINE)
    short, long_ = pair_sets()
    qs, ss = map(list, zip(*short))
    q4, s4 = map(list, zip(*long_))

    def digest(out) -> str:
        h = hashlib.sha256()
        if isinstance(out, list):
            for a in out:
                h.update(repr((a.score, a.start)).encode() + a.query_aligned
                         + a.subject_aligned)
        else:
            h.update(np.asarray(out).tobytes())
        return h.hexdigest()[:16]

    calls = (
        ("align_scores_batch 10,000 local", lambda: pt.align_scores_batch(
            qs, ss, "local", sc, device="cuda")),
        ("align_scores_batch 10,000 local affine",
         lambda: pt.align_scores_batch(qs, ss, "local", asc, device="cuda")),
        ("align_batch 10,000 local", lambda: pt.align_batch(
            qs, ss, "local", sc, device="cuda")),
        ("align_scores_batch 200 x 4,096 local",
         lambda: pt.align_scores_batch(q4, s4, "local", sc, device="cuda")),
    )
    for name, call in calls:
        walls, out = [], None
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            walls.append(round((time.perf_counter() - t0) * 1e3, 3))
        emit(tree=tree, call=name, walls_ms=walls, check=digest(out))


def shape_of(args) -> dict:
    q, s, ms, ns = args[:4]
    return {"B": q.shape[0], "m": int(ms.max()), "n": int(ns.max())}


def launch_fn(lib, args, **kw):
    """K7's wrapper on `args`; the lengths on the host where the tree's
    wrapper takes them there, as the batch calls give them (an older
    wrapper takes them on the card)."""
    from anyseq_tpu_torch.kernels import swarm

    if hasattr(swarm, "widths_of"):
        args = (*args[:2], *(x.cpu().numpy() for x in args[2:4]), *args[4:])
    return lambda: swarm.launch(lib, *args, **kw)


def run_tree(tree: str, reps: int) -> None:
    """One tree's public calls, then K7 alone at each shape."""
    lib = import_tree(tree)
    public_walls(tree)
    for name, args in shapes():
        fn = launch_fn(lib, args)
        runs, calls, check = timed_runs(fn, reps, "swarm", checksum, 4)
        emit(tree=tree, shape=name, **shape_of(args), runs_ms=runs,
             call_ms=calls, host_ms=host_runs(fn, 4 * reps, 4), check=check)


# the build of the code stores the sweep times beside this tree's: a copy
# of band_sweep.cuh whose Codes stores each segment at the step it is
# swept (no ring in shared memory), {name: [(text, replacement)]}
STORES = {"direct": [
    ("    ring.slot[r & (ROWS - 1)][threadIdx.x & 31] = bits;\n",
     "    store(r, bits);\n"),
    ("      if (r < h) store(r, ring.slot[r & (ROWS - 1)][threadIdx.x & 31]);"
     "\n", "      (void)r;\n"),
    ("  Segment<G::LANE_COLS * CODE_BITS> slot[ROWS][LANES];\n", ""),
]}


def store_libraries(tmp: str) -> dict:
    """{name: swarm.cu built from a copy of csrc/ with STORES[name]'s
    replacements in band_sweep.cuh, loaded with K7's signatures}."""
    import shutil

    from anyseq_tpu_torch.kernels import _build

    libs = {}
    for name, edits in STORES.items():
        src = os.path.join(tmp, name)
        shutil.copytree(_build.CSRC, src)
        core = os.path.join(src, "band_sweep.cuh")
        with open(core) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"band_sweep.cuh: not once: {old!r}")
            text = text.replace(old, new)
        with open(core, "w") as f:
            f.write(text)
        path = os.path.join(tmp, f"swarm-{name}.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        path, os.path.join(src, "swarm.cu")], check=True)
        lib = ctypes.CDLL(path)
        for fn in ("anyseq_swarm", "anyseq_swarm_plan"):
            getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def run_widths(reps: int) -> None:
    """This tree's K7 at every width at each shape, and with codes also
    the STORES builds."""
    from anyseq_tpu_torch.core.types import AffineScoring
    from anyseq_tpu_torch.kernels import swarm

    lib = import_tree(ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        stores = store_libraries(tmp)
        for name, args in shapes():
            affine, preds = isinstance(args[5], AffineScoring), args[8]
            launch_fn(lib, args)()
            rule = swarm.last_plan
            builds = (("this", lib), *stores.items()) if preds else (
                ("this", lib),)
            for build, which in builds:
                for w in swarm.widths_of(affine, preds):
                    runs, calls, check = timed_runs(
                        launch_fn(which, args, width=w), reps, "swarm",
                        checksum, 4)
                    plan = swarm.last_plan
                    emit(shape=name, **shape_of(args), width=w, build=build,
                         variant=f"{build} W={w}", rule=rule.width,
                         grid=plan.warps, strips=plan.strips,
                         scratch_bytes=plan.scratch_bytes, runs_ms=runs,
                         call_ms=calls, check=check)


def ptxas_report() -> None:
    """Registers and spills of every K7 instantiation; none may spill."""
    import chip_smoke as cs
    from anyseq_tpu_torch.kernels import _build

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, "swarm.o"), str(_build.CSRC / "swarm.cu")],
            capture_output=True, text=True, check=True)
    entries = cs.ptxas_entries(out.stdout + out.stderr)
    for kernel, flags, _, regs, spills in entries:
        print(f"check: ptxas swarm.cu {kernel}<{flags}>: {regs} registers, "
              f"{spills} bytes spilled", flush=True)
    cs.check(entries and all(e[4] == 0 for e in entries),
             "every K7 instantiation spills nothing")


def host_parts(reps: int) -> None:
    """This tree's wrapper at the small shapes and the (256, 256) score
    launch: its host time (``host_runs``, 20 x reps samples a part,
    medians in ms) whole and in parts -- the plan (``anyseq_swarm_plan``:
    the width rule, the strip list, the warps), the strip list's pinned
    buffer and its copy to the card, the zeroed outputs."""
    import torch

    from anyseq_tpu_torch.kernels._sweep import MODE_CODE

    lib = import_tree(ROOT)
    dev = torch.device("cuda")
    for name, args in shapes():
        if not name.startswith(("small", "score (256, 256) local")):
            continue
        q, s, ms, ns, mode = args[:5]
        ms, ns = (x.cpu().numpy().astype(np.int32) for x in (ms, ns))
        B, M, N = q.shape[0], q.shape[1], s.shape[1]
        meta = torch.empty(4 * B + 1, dtype=torch.int64, pin_memory=True)
        plan = np.zeros(4, np.int64)
        parts = {
            "call": launch_fn(lib, args),
            "plan": lambda: lib.anyseq_swarm_plan(
                ms.ctypes.data, ns.ctypes.data, B, 0, MODE_CODE[mode],
                int(args[8]), 0, 2**62, meta.data_ptr(), plan.ctypes.data),
            "strip list": lambda: torch.empty(
                4 * B + 1, dtype=torch.int64, pin_memory=True).to(
                    dev, non_blocking=True),
            "zeroed outputs": lambda: torch.zeros(
                B * (M + N + 3) + 1, dtype=torch.int32, device=dev),
        }
        emit(shape=name, **shape_of(args), host_ms={
            k: float(np.median(host_runs(fn, 20 * reps, 4)))
            for k, fn in parts.items()})


def key_of(x) -> tuple:
    return (x["call"], "") if "call" in x else (x["shape"], "")


def summary(lines, group: str) -> None:
    """Median and spread of each measurement by `group`."""
    print(f"medians ({smi('name,power.limit')}):", flush=True)
    for key, g, sel in grouped(lines, key_of, lambda x: x[group]):
        if "walls_ms" in sel[0]:
            print(f"{key[0]} {group}={g}: walls_ms cold / warm "
                  f"{[x['walls_ms'] for x in sel]}", flush=True)
            continue
        extra = "".join(f" {k}={sel[0][k]}" for k in
                        ("B", "m", "n", "rule", "grid", "strips",
                         "scratch_bytes") if k in sel[0])
        print(f"{key[0]} {group}={g}{extra}: {stats(sel, 4)[1]}", flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent")
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--host", action="store_true")
    p.add_argument("--reps", type=int, default=5)
    # one process of a plan: a tree's run (--tree), or this tree at every
    # width (--widths)
    p.add_argument("--tree")
    p.add_argument("--widths", action="store_true")
    a = p.parse_args()
    sys.path.insert(0, ROOT)
    if a.widths:
        run_widths(a.reps)
        return 0
    if a.tree:
        run_tree(os.path.abspath(a.tree), a.reps)
        return 0
    print(smi("name,power.limit"), flush=True)
    if a.check:
        import chip_smoke as cs

        ptxas_report()
        errors: dict = {}
        cs.phase2_swarm(np.random.default_rng(cs.SEED + 11), errors)
        print(f"check: K7 at phase 2's shapes equal to its plain version "
              f"{errors}", flush=True)
    if a.host:
        host_parts(a.reps)
    if a.sweep:
        lines = child(__file__, ["--widths", "--reps", str(a.reps)])
        if not equal_outputs(lines, key_of, "k7_probe"):
            return 1
        summary(lines, "variant")
    if a.parent:
        lines = in_turns(__file__, ROOT, os.path.abspath(a.parent), a.reps,
                         key_of, "k7_probe")
        if lines is None:
            return 1
        summary(lines, "which")
    print("k7_probe ok: outputs equal", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
