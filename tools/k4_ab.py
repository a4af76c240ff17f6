#!/usr/bin/env python3
"""K4 and K5L, the level sweeps (``kernels/lastcols.py``), of two
checkouts on one CUDA card, in turns; and this tree's level sweeps forced
to each width, the data behind the level rule.

    python3 tools/k4_ab.py --parent DIR [--reps 3]

DIR is an unpacked older tree. Each tree (older, this, this, older; each
a process of its own that builds its tree's kernels) drives the public
calls that run K4 / K5L, each cold then warm with its host wall and peak
device memory: ``align`` 100k semiglobal (linear, affine; seeded related
pairs as ``chip_smoke.py`` makes them), ``align`` 1 Mbp semiglobal and
``align`` 2.2 Mbp global affine. The cold call keeps the arguments of
every K4 / K5L launch it makes (one a divide level), and the tree then
times each of them alone through its own wrapper (``lastcols.launch`` /
``launch_affine``, at its own width rule). The outputs of all runs must be
equal. Prints one JSON line a measurement, then the medians with their
spreads (the kernel's device time, from torch.profiler; beside it the
wrapper's call timed with CUDA events, its host work included), each
call's sum over its levels, and the card's name and power limit.

    python3 tools/k4_ab.py --sweep [--reps 3]

runs this tree's K4 and K5L forced to each width they have on the same
levels, with the rule's width, warps, boundary scratch and critical path
beside each time; outputs held equal across widths.

    python3 tools/k4_ab.py --check

prints ptxas's registers, spills and DPX instructions of the strip
sources, then holds K4 and K5L at every width to their plain versions on
ragged levels (``chip_smoke.py`` phases 1 and 2 for these kernels); with
``--parent DIR``, also that the other kernels of the warp strip cores (K8,
K10, K1, K5 and their affine modes) build to DIR's registers, spills and
DPX counts. The options combine in one call.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import time

import numpy as np

from _ab import (child, emit, equal_outputs, grouped, import_tree, in_turns,
                 smi, stats, timed_runs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2024
AFFINE = (2, -1, -3, -1)
# the pairs' lengths: chip_smoke.py's 100k pair, k1_ab.py's 1 Mbp pair and
# a 2.2 Mbp pair whose first batched Myers-Miller level has 16 halves
PAIR_BP = 100_000
GENOME_BP = 1_000_000
HB_GENOME_BP = 2_200_000


def checksum(out) -> list:
    """Sums of a level sweep's output columns, plain and weighted, to hold
    runs equal."""
    import torch

    outs = out if isinstance(out, tuple) else (out,)
    w = torch.arange(outs[0].shape[1], device=outs[0].device) % 7 + 1
    return [int(c.long().sum()) for c in outs] + [
        int((c.long() * w).sum()) for c in outs]


def calls():
    """(name, kernel, function) of the public calls that run K4 / K5L."""
    import anyseq_tpu_torch as pt
    from chip_smoke import related_pair

    sc, asc = pt.LinearScoring(), pt.AffineScoring(*AFFINE)
    rng = np.random.default_rng(SEED)
    related_pair(rng, 1000)
    q100, s100 = related_pair(rng, PAIR_BP)
    q1m, s1m = related_pair(rng, GENOME_BP)
    q22, s22 = related_pair(np.random.default_rng(SEED + 9), HB_GENOME_BP)

    def aligned(q, s, mode, scoring):
        def call():
            a = pt.align(q, s, mode, scoring, device="cuda")
            return [a.score, *a.start, hashlib.sha256(
                a.query_aligned + a.subject_aligned).hexdigest()]
        return call

    return (("align 100k semiglobal", "K4",
             aligned(q100, s100, "semiglobal", sc)),
            ("align 100k semiglobal affine", "K5L",
             aligned(q100, s100, "semiglobal", asc)),
            ("align 1 Mbp semiglobal", "K4",
             aligned(q1m, s1m, "semiglobal", sc)),
            ("align 2.2 Mbp global affine", "K5L",
             aligned(q22, s22, "global", asc)))


def driven(tree: str):
    """Each public call of calls(), cold (keeping its K4 / K5L launches)
    then warm, emitted; returns [(call, kernel, [launch arguments])]."""
    import torch

    from anyseq_tpu_torch.kernels import lastcols

    levels = []
    for name, kernel, fn in calls():
        attr = "launch_affine" if kernel == "K5L" else "launch"
        real, kept = getattr(lastcols, attr), []

        def keep(*args, **kwargs):
            kept.append(args)
            return real(*args, **kwargs)

        walls, peaks, out = [], [], None
        for cold in (True, False):
            setattr(lastcols, attr, keep if cold else real)
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                walls.append(round(time.perf_counter() - t0, 6))
                peaks.append(torch.cuda.max_memory_allocated())
            finally:
                setattr(lastcols, attr, real)
        emit(tree=tree, call=name, walls_s=walls, peak_bytes=peaks,
             launches=len(kept), check=out)
        levels.append((name, kernel, kept))
    return levels


def level_fn(lib, kernel, args, **kw):
    from anyseq_tpu_torch.kernels import lastcols

    fn = lastcols.launch_affine if kernel == "K5L" else lastcols.launch
    return lambda: fn(lib, *args[1:], **kw)


def shape_of(args) -> dict:
    import torch

    ms, ns = (torch.as_tensor(x).cpu() for x in args[3:5])
    return {"B": len(ms), "m": int(ms.max()), "n": int(ns.max())}


def run_tree(tree: str, reps: int) -> None:
    """One tree's public calls, then each of their level launches alone."""
    lib = import_tree(tree)
    for name, kernel, kept in driven(tree):
        for idx, args in enumerate(kept):
            runs, calls_ms, check = timed_runs(level_fn(lib, kernel, args),
                                               reps, "lastcols", checksum)
            emit(tree=tree, kernel=kernel, shape=f"{name} launch {idx}",
                 **shape_of(args), runs_ms=runs, call_ms=calls_ms,
                 check=check)


def run_widths(tree: str, reps: int) -> None:
    """This tree's K4 and K5L at every width, on the same levels."""
    lib = import_tree(tree)
    import chip_smoke as cs
    from anyseq_tpu_torch.kernels import lastcols

    for name, kernel, kept in driven(tree):
        affine = kernel == "K5L"
        for idx, args in enumerate(kept):
            level_fn(lib, kernel, args)()
            rule = lastcols.last_plan
            for w in lastcols.AFFINE_WIDTHS if affine else lastcols.WIDTHS:
                runs, calls_ms, check = timed_runs(
                    level_fn(lib, kernel, args, width=w), reps, "lastcols",
                    checksum)
                plan = lastcols.last_plan
                emit(tree=tree, kernel=kernel, shape=f"{name} launch {idx}",
                     **shape_of(args), width=w, rule=rule.width,
                     grid=plan.warps, scratch_bytes=plan.scratch_bytes,
                     cap_bytes=plan.cap_bytes,
                     path_steps=cs.level_path_steps(affine, args[3],
                                                    args[4], w),
                     runs_ms=runs, call_ms=calls_ms, check=check)


def warp_core_report(tree: str) -> dict:
    """{"source kernel<flags>": [registers, spills, DPX counts]} of the warp
    strip cores' other kernels -- K8/K10 and K1 (band.cu), their affine
    modes and K5 (band_affine.cu) -- as nvcc builds them from `tree`'s
    sources (chip_smoke.py phase 1's report)."""
    import tempfile

    import chip_smoke as cs
    from anyseq_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    csrc = os.path.join(tree, "anyseq_tpu_torch", "kernels", "csrc")
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("band.cu", "band_affine.cu"):
            obj = os.path.join(tmp, name + ".o")
            out = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
                 os.path.join(csrc, name)], capture_output=True, text=True,
                check=True)
            sass = subprocess.run(
                [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
                 obj], capture_output=True, text=True, check=True).stdout
            dpx = {part.split()[0]: {op: part.count(op)
                                     for op in ("VIADDMNMX", "VIMNMX3")}
                   for part in sass.split("Function : ")[1:]}
            for kernel, flags, mangled, regs, spills in cs.ptxas_entries(
                    out.stdout + out.stderr):
                report[f"{name} {kernel}<{flags}>"] = [regs, spills,
                                                       dpx.get(mangled)]
    return report


def key_of(x) -> tuple:
    return (x.get("kernel"), x.get("shape"), x.get("call"))


def summary(lines, group: str) -> None:
    """Median and spread of each measurement by `group` (which tree, or
    width), and each call's levels summed by medians."""
    print(f"medians ({smi('name,power.limit')}):", flush=True)
    totals: dict = {}
    for key, g, sel in grouped(lines, key_of, lambda x: x.get(group)):
        label = " ".join(str(k) for k in key if k is not None)
        if "walls_s" in sel[0]:
            print(f"{label} {group}={g}: walls_s "
                  f"{[x['walls_s'] for x in sel]} peak_gb "
                  f"{[round(max(x['peak_bytes']) / 1e9, 3) for x in sel]}",
                  flush=True)
            continue
        med, text = stats(sel)
        extra = "".join(f" {k}={sel[0][k]}" for k in
                        ("B", "m", "n", "rule", "grid", "scratch_bytes",
                         "path_steps") if k in sel[0])
        print(f"{label} {group}={g}{extra}: {text}", flush=True)
        tot = (key[0], key[1].rsplit(" launch ", 1)[0], g)
        totals[tot] = totals.get(tot, 0.0) + med
    for (kernel, call, g), ms in totals.items():
        print(f"total {kernel} {call} {group}={g}: {ms:.3f} ms", flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent")
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--reps", type=int, default=3)
    # one process of a plan: a tree's run (--tree), or this tree at every
    # width (--widths)
    p.add_argument("--tree")
    p.add_argument("--widths", action="store_true")
    a = p.parse_args()
    sys.path.insert(0, ROOT)
    if a.widths:
        run_widths(ROOT, a.reps)
        return 0
    if a.tree:
        run_tree(os.path.abspath(a.tree), a.reps)
        return 0
    print(smi("name,power.limit"), flush=True)
    if a.check:
        import chip_smoke as cs

        cs.build_report()()
        errors: dict = {}
        cs.phase2_levels(errors)
        print(f"check: K4 and K5L at every width equal to their plain "
              f"versions {errors}", flush=True)
        if a.parent:
            ours = warp_core_report(ROOT)
            theirs = warp_core_report(os.path.abspath(a.parent))
            for k in sorted(ours.keys() | theirs.keys()):
                print(f"check: {k}: this {ours.get(k)} older "
                      f"{theirs.get(k)}", flush=True)
            if ours != theirs:
                print("k4_ab: the warp cores' other kernels differ from the "
                      "older tree's", file=sys.stderr)
                return 1
            print("check: K8/K10, K1, K5 and their affine modes build to "
                  "the older tree's registers, spills and DPX counts",
                  flush=True)
    if a.sweep:
        lines = child(__file__, ["--widths", "--reps", str(a.reps)])
        if not equal_outputs(lines, key_of, "k4_ab"):
            return 1
        summary([x for x in lines if "width" in x or "call" in x], "width")
    if a.parent:
        lines = in_turns(__file__, ROOT, os.path.abspath(a.parent), a.reps,
                         key_of, "k4_ab")
        if lines is None:
            return 1
        summary(lines, "which")
    print("k4_ab ok: outputs equal", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
