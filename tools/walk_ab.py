#!/usr/bin/env python3
"""K3 and K6, the traceback walks (``kernels/walk.py``), of two checkouts
on one CUDA card, in turns; and this tree's walks built with other window
shapes and schedules, the data behind the ones it keeps.

    python3 tools/walk_ab.py --parent DIR [--reps 5]

DIR is an unpacked older tree. Each tree (older, this, this, older; each
a process of its own that builds its tree's kernels) makes the walks'
inputs with its own kernels from seeded pairs, as ``chip_smoke.py`` makes
them, and times K3 and K6 through its own wrapper (``walk.launch`` /
``launch_affine``) at the main path's shapes: the 10k full tracebacks
(linear local, affine global), one pair of ~2000 x 3000 in each mode, the
largest stripe chunk of the 100k ``align`` (linear and affine, semiglobal)
and the largest K3 chunk of ``align_batch`` on 10,000 local pairs of ~256
bp; before them, the public calls that run those walks, once cold and
three times warm (host walls). The outputs of all runs must be equal. Prints one JSON line a
measurement, then the medians with their spreads (the kernel's device
time, from torch.profiler; beside it the wrapper's call timed with CUDA
events), and the card's name and power limit.

    python3 tools/walk_ab.py --sweep [--reps 5]

times this tree's walk sources built with each of VARIANTS' values of
walk_core.cuh's constants (the window's rows, the prefetch distance and
the steps between tests; in copies of the sources) at the same shapes;
outputs held equal across variants.

    python3 tools/walk_ab.py --check

prints ptxas's registers and spills of each variant, then holds every
variant to the plain versions at every shape, bit for bit. The options
combine in one call.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from _ab import (child, emit, equal_outputs, grouped, import_tree, in_turns,
                 smi, stats, timed_runs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2024
AFFINE = (2, -1, -3, -1)
# name: the window's values in walk_core.cuh that a build of the sweep
# changes (the first: the values the source keeps): r its rows, a the
# prefetch distance, b the steps between tests
VARIANTS = {
    "r96a32b16": {},
    "r64a24b16": {"ROWS": 64, "AHEAD": 24},
    "r32a16b8": {"ROWS": 32, "AHEAD": 16, "BLOCK": 8},
    "r96a40b32": {"AHEAD": 40, "BLOCK": 32},
}


def variant_source(tmp: str, name: str, values: dict) -> str:
    """A copy of csrc/ under tmp with walk_core.cuh's constants set to
    `values`; its directory."""
    import re
    import shutil

    from anyseq_tpu_torch.kernels import _build

    src = os.path.join(tmp, name)
    shutil.copytree(_build.CSRC, src)
    core = os.path.join(src, "walk_core.cuh")
    with open(core) as f:
        text = f.read()
    for key, value in values.items():
        text, hits = re.subn(rf"constexpr int {key} = \d+;",
                             f"constexpr int {key} = {value};", text)
        if hits != 1:
            raise RuntimeError(f"walk_core.cuh: no constant {key}")
    with open(core, "w") as f:
        f.write(text)
    return src


def build_variants(tmp: str, verbose: bool = False) -> dict:
    """{name: library} of walk.cu + walk_affine.cu built with each of
    VARIANTS' values, all nvcc runs at once; with `verbose`, ptxas's
    report of each."""
    from anyseq_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    procs = {}
    for name, values in VARIANTS.items():
        src = variant_source(tmp, name, values)
        lib = os.path.join(tmp, f"walk-{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib,
               os.path.join(src, "walk.cu"),
               os.path.join(src, "walk_affine.cu")]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{out}")
        if verbose:
            import chip_smoke as cs

            for kernel, flags, _, regs, spills in cs.ptxas_entries(out):
                print(f"check: ptxas {name} {kernel}: {regs} registers, "
                      f"{spills} bytes spilled", flush=True)
        lib = ctypes.CDLL(path)
        for fn in ("anyseq_walk", "anyseq_walk_affine"):
            getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def shapes():
    """[(kernel, shape name, launch arguments after the library)] of the
    walks at the main path's shapes, made with this process's kernels."""
    import torch

    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch.core.types import Mode
    from anyseq_tpu_torch.engine import linmem
    from anyseq_tpu_torch.kernels import walk, wavefront
    from chip_smoke import related_pair

    sc, asc = pt.LinearScoring(), pt.AffineScoring(*AFFINE)
    dev = torch.device("cuda")
    out = []

    def dev_u8(b):
        return torch.frombuffer(bytearray(b), dtype=torch.uint8).to(dev)

    def pair_walk(tag, q, s, mode, scoring):
        affine = scoring is asc
        outs = wavefront.score(q, s, mode, scoring, emit_preds=True)
        end = linmem.extract_end(outs, q.numel(), s.numel(), mode)[None, 1:]
        args = (outs["preds"][None], q[None], s[None],
                end.to(torch.int32), mode)
        if affine:
            no_gap = torch.zeros(1, dtype=torch.bool, device=dev)
            args += (no_gap, no_gap)
        out.append(("K6" if affine else "K3", tag, args))

    rng = np.random.default_rng(SEED)
    q, s = (dev_u8(x) for x in related_pair(rng, 10_000))
    pair_walk("10k full traceback local", q, s, Mode.LOCAL, sc)
    pair_walk("10k full traceback global affine", q, s, Mode.GLOBAL, asc)
    qb, sb = related_pair(rng, 2000)
    q = dev_u8(qb)
    s = dev_u8(sb + related_pair(rng, 3000 - len(sb))[0])
    for mode in Mode:
        for scoring in (sc, asc):
            pair_walk(f"2000x3000 {mode.value}", q, s, mode, scoring)

    def kept(call, attr):
        """The launch arguments of every `attr` launch in call()."""
        real, got = getattr(walk, attr), []

        def keep(*args, **kwargs):
            got.append(args[1:])
            return real(*args, **kwargs)

        setattr(walk, attr, keep)
        try:
            call()
        finally:
            setattr(walk, attr, real)
        return max(got, key=lambda a: a[0].shape[0])

    q, s = related_pair(np.random.default_rng(SEED + 1), 100_000)
    out.append(("K3", "100k align largest stripe chunk", kept(
        lambda: pt.align(q, s, "semiglobal", sc, device="cuda"), "launch")))
    out.append(("K6", "100k align largest stripe chunk", kept(
        lambda: pt.align(q, s, "semiglobal", asc, device="cuda"),
        "launch_affine")))
    brng = np.random.default_rng(SEED + 2)
    qs, ss = zip(*(related_pair(brng, 256) for _ in range(10_000)))
    out.append(("K3", "align_batch 10,000 local largest chunk", kept(
        lambda: pt.align_batch(list(qs), list(ss), "local", sc,
                               device="cuda"), "launch")))
    return out


def launch_fn(lib, kernel, args):
    from anyseq_tpu_torch.kernels import walk

    fn = walk.launch_affine if kernel == "K6" else walk.launch
    return lambda: fn(lib, *args)


def checksum(out) -> list:
    """Sums of a walk's outputs, plain and weighted, to hold runs equal."""
    import torch

    sums = []
    for t in out:
        w = torch.arange(t.numel(), device=t.device) % 7 + 1
        sums += [int(t.long().sum()), int((t.long().flatten() * w).sum())]
    return sums


def steps_of(kernel, args, lib) -> int:
    """The longest walk's steps (its live positions)."""
    out_q = launch_fn(lib, kernel, args)()[0]
    return int((out_q != ord(" ")).sum(1).max())


def public_walls(tree: str) -> None:
    """The public calls that run K3 / K6, each once cold and three times
    warm (host clock around the call, ending in a synchronize): the 10k
    full tracebacks, the 100k semiglobal ``align``s, ``align_batch`` on
    10,000 local pairs of ~256 bp and, affine, on the first 1,000 (the
    inputs of shapes())."""
    import hashlib

    import torch

    import anyseq_tpu_torch as pt
    from chip_smoke import related_pair

    sc, asc = pt.LinearScoring(), pt.AffineScoring(*AFFINE)
    q10, s10 = related_pair(np.random.default_rng(SEED), 10_000)
    q100, s100 = related_pair(np.random.default_rng(SEED + 1), 100_000)
    brng = np.random.default_rng(SEED + 2)
    qs, ss = map(list, zip(*(related_pair(brng, 256)
                             for _ in range(10_000))))

    def digest(out) -> str:
        alns = out if isinstance(out, list) else [out]
        h = hashlib.sha256()
        for a in alns:
            h.update(repr((a.score, a.start)).encode() + a.query_aligned
                     + a.subject_aligned)
        return h.hexdigest()[:16]

    calls = (
        ("align_full_tb 10k local", lambda: pt.align_full_tb(
            q10, s10, "local", sc, device="cuda")),
        ("align_full_tb 10k global affine", lambda: pt.align_full_tb(
            q10, s10, "global", asc, device="cuda")),
        ("align 100k semiglobal", lambda: pt.align(
            q100, s100, "semiglobal", sc, device="cuda")),
        ("align 100k semiglobal affine", lambda: pt.align(
            q100, s100, "semiglobal", asc, device="cuda")),
        ("align_batch 10,000 local", lambda: pt.align_batch(
            qs, ss, "local", sc, device="cuda")),
        # affine: one align a pair (K5p and K6 a pair), as in the JAX package
        ("align_batch 1,000 local affine", lambda: pt.align_batch(
            qs[:1000], ss[:1000], "local", asc, device="cuda")),
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


def run_tree(tree: str, reps: int) -> None:
    lib = import_tree(tree)
    public_walls(tree)
    for kernel, shape, args in shapes():
        runs, calls, check = timed_runs(launch_fn(lib, kernel, args), reps,
                                        "walk", checksum, 4)
        emit(tree=tree, kernel=kernel, shape=shape, B=args[0].shape[0],
             steps=steps_of(kernel, args, lib), runs_ms=runs,
             call_ms=calls, check=check)


def run_variants(reps: int) -> None:
    import_tree(ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        for kernel, shape, args in shapes():
            for name, lib in libs.items():
                runs, calls, check = timed_runs(launch_fn(lib, kernel, args),
                                                reps, "walk", checksum, 4)
                emit(variant=name, kernel=kernel, shape=shape,
                     B=args[0].shape[0], runs_ms=runs, call_ms=calls,
                     check=check)


def check_variants() -> dict:
    """Every variant equal to the plain versions at every shape."""
    from anyseq_tpu_torch.kernels import walk

    import_tree(ROOT)
    errors = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, verbose=True)
        for kernel, shape, args in shapes():
            t0 = time.perf_counter()
            plain = walk.plain_affine if kernel == "K6" else walk.plain
            want = plain(*args)
            plain_s = time.perf_counter() - t0
            for name, lib in libs.items():
                got = launch_fn(lib, kernel, args)()
                equal = all(bool((a == b).all())
                            for a, b in zip(got, want, strict=True))
                errors[f"{kernel} {shape} {name}"] = equal
                if not equal:
                    print(f"walk_ab: {kernel} {shape} {name} differs from "
                          f"the plain version", file=sys.stderr)
            print(f"check: {kernel} {shape} B={args[0].shape[0]} "
                  f"{args[1].shape[1]}x{args[2].shape[1]}: "
                  f"{len(libs)} variants equal to plain "
                  f"({plain_s:.1f} s)", flush=True)
    return errors


def key_of(x) -> tuple:
    return (x["call"], "") if "call" in x else (x["kernel"], x["shape"])


def summary(lines, group: str) -> None:
    """Median and spread of each measurement by `group`."""
    print(f"medians ({smi('name,power.limit')}):", flush=True)
    for key, g, sel in grouped(lines, key_of, lambda x: x[group]):
        if "walls_ms" in sel[0]:
            print(f"{key[0]} {group}={g}: walls_ms cold / warm "
                  f"{[x['walls_ms'] for x in sel]}", flush=True)
            continue
        extra = "".join(f" {k}={sel[0][k]}" for k in ("B", "steps")
                        if k in sel[0])
        print(f"{key[0]} {key[1]} {group}={g}{extra}: {stats(sel, 4)[1]}",
              flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent")
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--reps", type=int, default=5)
    # one process of a plan: a tree's run (--tree), or this tree's
    # variants (--variants)
    p.add_argument("--tree")
    p.add_argument("--variants", action="store_true")
    a = p.parse_args()
    sys.path.insert(0, ROOT)
    if a.variants:
        run_variants(a.reps)
        return 0
    if a.tree:
        run_tree(os.path.abspath(a.tree), a.reps)
        return 0
    print(smi("name,power.limit"), flush=True)
    if a.check:
        errors = check_variants()
        if not all(errors.values()):
            return 1
        print(f"check: all {len(errors)} variant walks equal to the plain "
              f"versions", flush=True)
    if a.sweep:
        lines = child(__file__, ["--variants", "--reps", str(a.reps)])
        if not equal_outputs(lines, key_of, "walk_ab"):
            return 1
        summary(lines, "variant")
    if a.parent:
        lines = in_turns(__file__, ROOT, os.path.abspath(a.parent), a.reps,
                         key_of, "walk_ab")
        if lines is None:
            return 1
        summary(lines, "which")
    print("walk_ab ok: outputs equal", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
