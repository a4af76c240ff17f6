#!/usr/bin/env python3
"""K1 and K5, the single-pair score sweeps (``kernels/wavefront.py``), of
two checkouts on one CUDA card, in turns; and this tree's sweep over the
strip widths that sets their width rule.

    python3 tools/k1_ab.py --parent DIR [--reps 3]

DIR is an unpacked older tree. Each tree (older, this, this, older; each
a process of its own that builds its tree's kernels) times K1 and K5
alone through its own wrappers (``wavefront.launch`` / ``launch_affine``,
score only, at the width its rule chooses) at the main path's shapes: the
1k global score, the 100k local scores (seeded related pairs, as
``chip_smoke.py`` makes them), every score sweep of the 100k semiglobal
``align`` (linear and affine: the endpoint passes and the halves, taken
from the tree's own run of it) and a 524,288 x 1,000,000 one-piece global
sweep (linear also as one K8 band from the boundary's tensors); K8 on a
262,144-row band at 1,000,000 and 4,600,000 columns and K8
affine at 1,000,000, to show them unchanged; the 1 Mbp global score as one
K1 sweep and as the chain of four K8 bands that ``align_score`` runs
(ROADMAP R2); and the public calls, each cold then warm (host walls to
the result): ``align_score`` 1k global, 100k local (linear, affine), 1 Mbp
global linear and local affine, 4.6 Mbp global; ``align`` 100k
semiglobal (linear, affine) and 1 Mbp semiglobal. The outputs of all runs
must be equal. Prints one JSON line a measurement, then the medians with
their spreads and the card's name and power limit.

    python3 tools/k1_ab.py --sweep [--reps 3]

runs this tree's K1 and K5 forced to each width they have, at the same
shapes, with the width and warps the rule chooses beside each time;
outputs held equal across widths.

    python3 tools/k1_ab.py --check

prints ptxas's registers, spills and DPX instructions of the strip
sources, then holds K1 and K5 at every width to their plain versions
(``chip_smoke.py`` phases 1 and 2 for these kernels);
``--sass NAMES [--sass-dir DIR]`` writes the SASS of the K1 / K5 kernels
whose mangled names hold one of NAMES (comma-separated) to DIR (default
``anyseq_tpu_torch/_build/sass``). The options combine in one call.

    python3 tools/k1_ab.py --preds [--check] [--sweep] [--parent DIR]

does the same for K2 and K5p, the sweeps with codes: ``--check`` holds
them at every width to their plain versions (``chip_smoke.py``'s ptxas
report and ``phase2_code_sweeps``); ``--sweep`` times this tree's K2 / K5p
forced to each width they have; ``--parent`` times each tree's K2 / K5p
at its own widths in turns, device times (torch.profiler) and calls timed
with CUDA events, at the 10k full tracebacks (K2 local, K5p global), at
2,048 x 2,048 (``align``'s ``auto`` cap of 2^22 cells) and at 256 x 256,
local (and at ``chip_smoke.py``'s phase 2 shape, 2,000 x 3,000); then
the walls of ``align_full_tb`` 10k (local, global affine),
``align`` auto at 2,048 x 2,048 (local, linear and affine) and affine
``align_batch`` of 1,000 ~256 bp local pairs, each cold then warm, and
one profile of that batch: its device time, and K5p's and K6's in it.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

from _ab import (child, emit, equal_outputs, grouped, import_tree, in_turns,
                 smi, stats)
from _ab import timed_runs as profiled_runs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2024
BAND_ROWS = 262_144
TALL = (524_288, 1_000_000)       # the tallest one-piece sweep, x 1 M
GENOME_BP = 1_000_000
ECOLI_BP = 4_600_000
AFFINE = (2, -1, -3, -1)
# --preds: (name, m, n, mode, affine) of the K2 / K5p sweeps
CODE_SHAPES = (("full_tb 10k", 10_000, 10_000, "local", False),
               ("full_tb 10k", 10_000, 10_000, "global", True),
               ("auto cap 2048", 2048, 2048, "local", False),
               ("auto cap 2048", 2048, 2048, "local", True),
               ("chip_smoke phase 2", 2000, 3000, "local", False),
               ("chip_smoke phase 2", 2000, 3000, "local", True),
               ("batch pair 256", 256, 256, "local", False),
               ("batch pair 256", 256, 256, "local", True))
BATCH_PAIRS = 1000


def checksum(out) -> list:
    """Sums of a sweep's outputs and its best, to hold runs equal."""
    return [int(out[k].long().sum()) for k in sorted(out) if k != "best"] \
        + out["best"].tolist()


def timed_runs(fn, reps: int):
    """`reps` runs of fn() timed with CUDA events, after one warm-up, and
    the last output's checksum."""
    import torch

    fn()
    runs, check = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(round(start.elapsed_time(end), 3))
        check = checksum(out)
        del out
    return runs, check


def sweep_shapes(dev):
    """(name, q, s, mode, scoring, start_gap, emit_col_e) of the score
    sweeps of the main path: the 1k global score, the 100k local scores,
    every sweep of the 100k semiglobal ``align`` (linear and affine, as
    this tree's run of it launches them) and the tall one-piece sweep."""
    import torch

    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch.core.types import Mode, as_tensor
    from anyseq_tpu_torch.kernels import wavefront
    from chip_smoke import related_pair

    sc, asc = pt.LinearScoring(), pt.AffineScoring(*AFFINE)
    rng = np.random.default_rng(SEED)
    q1k, s1k = related_pair(rng, 1000)
    q100, s100 = related_pair(rng, 100_000)
    shapes = []
    for scoring in (sc, asc):
        shapes.append(("score 1k global", as_tensor(q1k, dev),
                       as_tensor(s1k, dev), Mode.GLOBAL, scoring, False,
                       False))
        shapes.append(("score 100k local", as_tensor(q100, dev),
                       as_tensor(s100, dev), Mode.LOCAL, scoring, False,
                       False))
    # the 100k align's sweeps, from a run with its launches kept
    real = wavefront.launch, wavefront.launch_affine
    kept = []

    def keep(affine):
        def launch(lib, q, s, mode, scoring, emit_preds, *rest, **kw):
            if not emit_preds:
                sg, col_e = rest[:2] if affine else (False, False)
                kept.append((q.clone(), s.clone(), mode, scoring, sg, col_e))
            return real[affine](lib, q, s, mode, scoring, emit_preds, *rest,
                                **kw)
        return launch

    wavefront.launch, wavefront.launch_affine = keep(False), keep(True)
    try:
        for scoring in (sc, asc):
            pt.align(q100, s100, "semiglobal", scoring, device=dev)
    finally:
        wavefront.launch, wavefront.launch_affine = real
    seen = set()
    for q, s, mode, scoring, sg, col_e in kept:
        key = (q.numel(), s.numel(), mode, type(scoring), sg)
        if key not in seen:
            seen.add(key)
            shapes.append((f"align 100k semiglobal {mode.value}"
                           + (" start_gap" if sg else ""), q, s, mode,
                           scoring, sg, col_e))
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    tall = [torch.from_numpy(alpha[rng.integers(0, 4, k)]).to(dev)
            for k in TALL]
    for scoring in (sc, asc):
        shapes.append(("tall one-piece global", *tall, Mode.GLOBAL, scoring,
                       False, False))
    return shapes


def sweep_fn(lib, q, s, mode, scoring, sg, col_e, **kw):
    from anyseq_tpu_torch.core.types import AffineScoring
    from anyseq_tpu_torch.kernels import wavefront

    if isinstance(scoring, AffineScoring):
        return lambda: wavefront.launch_affine(lib, q, s, mode, scoring,
                                               False, sg, col_e, **kw)
    return lambda: wavefront.launch(lib, q, s, mode, scoring, False, **kw)


def kernel_name(scoring) -> str:
    return "K5" if hasattr(scoring, "gap_open") else "K1"


def run_widths(tree: str, reps: int) -> None:
    """This tree's K1 and K5 at every width, at the main path's shapes."""
    lib = import_tree(tree)
    from anyseq_tpu_torch.kernels import band
    from anyseq_tpu_torch.kernels._sweep import MODE_CODE

    for name, q, s, mode, scoring, sg, col_e in sweep_shapes("cuda"):
        affine = kernel_name(scoring) == "K5"
        m, n = q.numel(), s.numel()
        pre = "anyseq_sweep_affine" if affine else "anyseq_sweep"
        rule = getattr(lib, pre + "_width")(m, n, MODE_CODE[mode], 0)
        widths = band.AFFINE_WIDTHS if affine else band.WIDTHS
        if m >= TALL[0]:
            # the boundary columns take (strips - 1) x m ints: the widest two
            widths = widths[:1 if affine else 2]
        for w in widths:
            runs, check = timed_runs(sweep_fn(lib, q, s, mode, scoring, sg,
                                              col_e, width=w), reps)
            emit(tree=tree, kernel=kernel_name(scoring), shape=name, m=m,
                 n=n, width=w, rule=rule,
                 grid=getattr(lib, pre + "_grid")(m, n, MODE_CODE[mode], w,
                                                  0),
                 runs_ms=runs, check=check)


def run_tree(tree: str, reps: int) -> None:
    """One tree's K1 / K5 at its own widths, K8, the R2 pair and the
    public calls."""
    lib = import_tree(tree)
    import torch

    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch.core.types import Mode, as_tensor
    from anyseq_tpu_torch.engine import affine as aff
    from anyseq_tpu_torch.engine import linmem
    from anyseq_tpu_torch.kernels import band, wavefront
    from chip_smoke import related_pair

    dev = "cuda"
    for name, q, s, mode, scoring, sg, col_e in sweep_shapes(dev):
        runs, check = timed_runs(sweep_fn(lib, q, s, mode, scoring, sg,
                                          col_e), reps)
        emit(tree=tree, kernel=kernel_name(scoring), shape=name,
             m=q.numel(), n=s.numel(), runs_ms=runs, check=check)
        if name.startswith("tall") and kernel_name(scoring) == "K1":
            # the same sweep as one K8 band from the boundary's tensors
            m, n = q.numel(), s.numel()
            args = (q, s, linmem.top_row(mode, scoring, n, q.device),
                    *linmem.left_col(mode, scoring, 0, m, q.device), mode,
                    scoring)
            runs, check = timed_runs(lambda: band.launch(lib, *args), reps)
            emit(tree=tree, kernel="K8", shape=name, m=m, n=n,
                 runs_ms=runs, check=check)
            del args

    # K8 and K8 affine on one band, as tools/k8_ab.py runs them
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = torch.from_numpy(alpha[rng.integers(0, 4, BAND_ROWS)]).to(dev)
    s_all = torch.from_numpy(alpha[rng.integers(0, 4, ECOLI_BP)]).to(dev)
    sc, asc = pt.LinearScoring(), pt.AffineScoring(*AFFINE)
    for n in (GENOME_BP, ECOLI_BP):
        s = s_all[:n].contiguous()
        args = (q, s, linmem.top_row(Mode.GLOBAL, sc, n, q.device),
                *linmem.left_col(Mode.GLOBAL, sc, 0, BAND_ROWS, q.device),
                Mode.GLOBAL, sc)
        runs, check = timed_runs(lambda: band.launch(lib, *args), reps)
        emit(tree=tree, kernel="K8", shape="band global", m=BAND_ROWS, n=n,
             runs_ms=runs, check=check)
    s = s_all[:GENOME_BP].contiguous()
    args = (q, s, *aff.top_row_affine(Mode.LOCAL, asc, GENOME_BP, False,
                                      q.device),
            *aff.left_col_affine(Mode.LOCAL, asc, 0, BAND_ROWS, False,
                                 q.device), Mode.LOCAL, asc)
    runs, check = timed_runs(lambda: band.launch_affine(lib, *args), reps)
    emit(tree=tree, kernel="K8 affine", shape="band local", m=BAND_ROWS,
         n=GENOME_BP, runs_ms=runs, check=check)
    del s_all, args

    # R2: the 1 Mbp global score as one K1 sweep and as the chain of bands
    rng = np.random.default_rng(SEED + 3)
    q1, s1 = (as_tensor(x, dev) for x in related_pair(rng, GENOME_BP))
    runs, check = timed_runs(
        lambda: wavefront.launch(lib, q1, s1, Mode.GLOBAL, sc, False), reps)
    emit(tree=tree, kernel="K1", shape="R2 1 Mbp global one piece",
         m=q1.numel(), n=s1.numel(), runs_ms=runs, check=check)
    runs, check = timed_runs(
        lambda: band.score_pair_chained(q1, s1, Mode.GLOBAL, sc), reps)
    emit(tree=tree, kernel="K8 chain", shape="R2 1 Mbp global chain",
         m=q1.numel(), n=s1.numel(), runs_ms=runs, check=check)
    del q1, s1
    public_calls(tree)


def public_calls(tree: str) -> None:
    """The public calls of PERF.md section 5 that run K1, K5 or K8, each
    cold then warm: host walls to the result."""
    import torch

    import anyseq_tpu_torch as pt
    from chip_smoke import related_pair

    sc, asc = pt.LinearScoring(), pt.AffineScoring(*AFFINE)
    rng = np.random.default_rng(SEED)
    q1k, s1k = related_pair(rng, 1000)
    q100, s100 = related_pair(rng, 100_000)
    q1m, s1m = related_pair(rng, GENOME_BP)
    q46, s46 = related_pair(rng, ECOLI_BP)

    def score(q, s, mode, scoring):
        return lambda: pt.align_score(q, s, mode, scoring, device="cuda")

    def aligned(q, s, mode, scoring):
        def call():
            a = pt.align(q, s, mode, scoring, device="cuda")
            return [a.score, *a.start]
        return call

    calls = (
        ("align_score 1k global", score(q1k, s1k, "global", sc), 4),
        ("align_score 100k local", score(q100, s100, "local", sc), 2),
        ("align_score 100k local affine", score(q100, s100, "local", asc),
         2),
        ("align 100k semiglobal", aligned(q100, s100, "semiglobal", sc), 2),
        ("align 100k semiglobal affine",
         aligned(q100, s100, "semiglobal", asc), 2),
        ("align_score 1 Mbp global", score(q1m, s1m, "global", sc), 2),
        ("align_score 1 Mbp local affine", score(q1m, s1m, "local", asc),
         2),
        ("align 1 Mbp semiglobal", aligned(q1m, s1m, "semiglobal", sc), 2),
        ("align_score 4.6 Mbp global", score(q46, s46, "global", sc), 1),
    )
    for name, fn, times in calls:
        walls, out = [], None
        for _ in range(times):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append(round(time.perf_counter() - t0, 6))
        emit(tree=tree, call=name, walls_s=walls, check=out)


def code_shapes(dev):
    """(name, q, s, mode, scoring) of the K2 / K5p sweeps of CODE_SHAPES:
    seeded related pairs, the subject cut or filled to n."""
    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch.core.types import Mode, as_tensor
    from chip_smoke import related_pair

    rng = np.random.default_rng(SEED + 20)
    out = []
    for name, m, n, mode, affine in CODE_SHAPES:
        qb, sb = related_pair(rng, m)
        sb = (sb + related_pair(rng, n)[0])[:n]
        out.append((f"{name} {mode}", as_tensor(qb, dev), as_tensor(sb, dev),
                    Mode.parse(mode), pt.AffineScoring(*AFFINE) if affine
                    else pt.LinearScoring()))
    return out


def code_kernel(lib, affine: bool) -> str:
    """The name K2's (K5p's) kernel has in the profiler in either tree:
    the warp strip cores' band kernels, or before them the CTA cores'."""
    if hasattr(lib, "anyseq_wavefront"):
        return "wavefront_affine_kernel" if affine else "wavefront_kernel"
    return "band_affine_kernel" if affine else "band_kernel"


def code_fn(lib, q, s, mode, scoring, **kw):
    from anyseq_tpu_torch.kernels import wavefront

    if hasattr(scoring, "gap_open"):
        return lambda: wavefront.launch_affine(lib, q, s, mode, scoring,
                                               True, False, False, **kw)
    return lambda: wavefront.launch(lib, q, s, mode, scoring, True, **kw)


def run_code_widths(tree: str, reps: int) -> None:
    """This tree's K2 and K5p at every width they have, at CODE_SHAPES."""
    lib = import_tree(tree)
    from anyseq_tpu_torch.kernels import band
    from anyseq_tpu_torch.kernels._sweep import MODE_CODE

    for name, q, s, mode, scoring in code_shapes("cuda"):
        affine = hasattr(scoring, "gap_open")
        m, n = q.numel(), s.numel()
        pre = "anyseq_sweep_affine" if affine else "anyseq_sweep"
        rule = getattr(lib, pre + "_width")(m, n, MODE_CODE[mode], 1)
        for w in band.AFFINE_CODE_WIDTHS if affine else band.CODE_WIDTHS:
            runs, calls, check = profiled_runs(
                code_fn(lib, q, s, mode, scoring, width=w), reps,
                code_kernel(lib, affine), checksum, 4)
            emit(tree=tree, kernel="K5p" if affine else "K2", shape=name,
                 m=m, n=n, width=w, rule=rule,
                 grid=getattr(lib, pre + "_grid")(m, n, MODE_CODE[mode], w,
                                                  1),
                 runs_ms=runs, call_ms=calls, check=check)


def run_code_tree(tree: str, reps: int) -> None:
    """One tree's K2 / K5p at its own widths, and the public calls that
    run them."""
    lib = import_tree(tree)
    for name, q, s, mode, scoring in code_shapes("cuda"):
        affine = hasattr(scoring, "gap_open")
        runs, calls, check = profiled_runs(
            code_fn(lib, q, s, mode, scoring), reps,
            code_kernel(lib, affine), checksum, 4)
        emit(tree=tree, kernel="K5p" if affine else "K2", shape=name,
             m=q.numel(), n=s.numel(), runs_ms=runs, call_ms=calls,
             check=check)
    code_calls(tree, lib)


def code_calls(tree: str, lib) -> None:
    """The public calls that run K2 / K5p, each cold then warm (host
    walls to the result), and one profile of the affine batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import anyseq_tpu_torch as pt
    from chip_smoke import related_pair

    sc, asc = pt.LinearScoring(), pt.AffineScoring(*AFFINE)
    rng = np.random.default_rng(SEED + 21)
    q10, s10 = related_pair(rng, 10_000)
    q2k, s2k = related_pair(rng, 2048)
    s2k = (s2k + related_pair(rng, 2048)[0])[:2048]
    pairs = [related_pair(rng, 256) for _ in range(BATCH_PAIRS)]
    qs, ss = [p[0] for p in pairs], [p[1] for p in pairs]

    def aligned(fn, *args):
        def call():
            a = fn(*args, device="cuda")
            return [a.score, *a.start]
        return call

    def batch():
        out = pt.align_batch(qs, ss, "local", asc, device="cuda")
        return [sum(a.score for a in out), sum(sum(a.start) for a in out)]

    calls = (
        ("align_full_tb 10k local", aligned(pt.align_full_tb, q10, s10,
                                            "local", sc)),
        ("align_full_tb 10k global affine",
         aligned(pt.align_full_tb, q10, s10, "global", asc)),
        ("align auto 2048 local", aligned(pt.align, q2k, s2k, "local", sc)),
        ("align auto 2048 local affine",
         aligned(pt.align, q2k, s2k, "local", asc)),
        (f"align_batch {BATCH_PAIRS} ~256 bp local affine", batch),
    )
    for name, fn in calls:
        walls, out = [], None
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append(round(time.perf_counter() - t0, 6))
        emit(tree=tree, call=name, walls_s=walls, check=out)
    # where the affine batch's device time goes (the profiler's own cost
    # lengthens the wall it reports beside)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = batch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]

    def busy(kernel=""):
        sel = [e for e in events if kernel in e.name]
        return (round(sum(e.time_range.end - e.time_range.start
                          for e in sel) / 1e3, 4), len(sel))

    emit(tree=tree, call=f"align_batch {BATCH_PAIRS} ~256 bp local affine "
         "profile", profiled_wall_ms=round(wall * 1e3, 3),
         busy_ms=busy()[0], k5p=busy(code_kernel(lib, True)),
         k6=busy("walk_affine_kernel"), check=out)


def key_of(x) -> tuple:
    return (x.get("kernel"), x.get("shape"), x.get("m"), x.get("n"),
            x.get("call"))


def summary(lines, groups) -> None:
    """Median and spread of each measurement, by `groups` (a key of the
    lines: tree, or width)."""
    print(f"medians ({smi('name,power.limit')}):", flush=True)
    for key, group, sel in grouped(
            lines, key_of, lambda x: tuple(x.get(g) for g in groups)):
        label = " ".join(str(k) for k in key if k is not None)
        tag = " ".join(f"{g}={v}" for g, v in zip(groups, group))
        if "walls_s" in sel[0]:
            walls = [x["walls_s"] for x in sel]
            print(f"{label} {tag}: walls_s {walls}", flush=True)
            continue
        if "busy_ms" in sel[0]:
            print(f"{label} {tag}: " + "; ".join(
                f"profiled_wall_ms {x['profiled_wall_ms']} busy_ms "
                f"{x['busy_ms']} k5p (ms, launches) {x['k5p']} k6 {x['k6']}"
                for x in sel), flush=True)
            continue
        extra = (f" grid={sel[0]['grid']} rule={sel[0]['rule']}"
                 if "grid" in sel[0] else "")
        print(f"{label} {tag}{extra}: {stats(sel)[1]}", flush=True)


def sass(kernels: str, out_dir: str) -> None:
    """The SASS of this tree's K1 / K5 instantiations whose mangled names
    hold each of `kernels` (comma-separated substrings), from an nvcc build
    of band.cu and band_affine.cu, into `out_dir`."""
    import tempfile

    sys.path.insert(0, ROOT)
    from anyseq_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("band.cu", "band_affine.cu"):
            obj = os.path.join(tmp, name + ".o")
            subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", "-o", obj,
                            str(_build.CSRC / name)], check=True)
            dump = subprocess.run(
                [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
                 obj], capture_output=True, text=True, check=True).stdout
            for part in dump.split("Function : ")[1:]:
                fn = part.split()[0]
                if any(k in fn for k in kernels.split(",")):
                    path = os.path.join(out_dir, f"sass_{fn}.txt")
                    with open(path, "w") as f:
                        f.write(part)
                    print(f"sass {fn}: {part.count(chr(10))} lines -> "
                          f"{path}", flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent")
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--sass", help="mangled-name substrings of kernels "
                   "whose SASS to write to --sass-dir")
    p.add_argument("--sass-dir", default=os.path.join(
        ROOT, "anyseq_tpu_torch", "_build", "sass"))
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--preds", action="store_true",
                   help="K2 / K5p, the sweeps with codes")
    # one process of a plan: a tree's run (--tree), or this tree at every
    # width (--widths)
    p.add_argument("--tree")
    p.add_argument("--widths", action="store_true")
    a = p.parse_args()
    sys.path.insert(0, ROOT)
    if a.widths:
        (run_code_widths if a.preds else run_widths)(ROOT, a.reps)
        return 0
    if a.tree:
        (run_code_tree if a.preds else run_tree)(os.path.abspath(a.tree),
                                                 a.reps)
        return 0
    print(smi("name,power.limit"), flush=True)
    if a.sass:
        sass(a.sass, a.sass_dir)
    extra = ["--preds"] if a.preds else []
    if a.check:
        import chip_smoke as cs

        cs.build_report()()
        errors: dict = {}
        (cs.phase2_code_sweeps if a.preds else cs.phase2_sweeps)(errors)
        print(f"check: {'K2 and K5p' if a.preds else 'K1 and K5'} at every "
              f"width equal to their plain versions {errors}", flush=True)
    if a.sweep:
        lines = child(__file__, ["--widths", "--reps", str(a.reps), *extra])
        if not equal_outputs(lines, key_of, "k1_ab"):
            return 1
        summary(lines, ("width",))
    if a.parent:
        lines = in_turns(__file__, ROOT, os.path.abspath(a.parent), a.reps,
                         key_of, "k1_ab", extra)
        if lines is None:
            return 1
        summary(lines, ("which",))
    print("k1_ab ok: outputs equal", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
