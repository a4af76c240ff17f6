#!/usr/bin/env python3
"""K8 (``csrc/band.cu``) or K8 affine and K10 affine
(``csrc/band_affine.cu``) of two checkouts on one CUDA card, in turns.

    python3 tools/k8_ab.py --parent DIR [--affine] [--check]
                           [--rows 262144] [--reps 3] [--sweep SPECS]

DIR is an unpacked older tree. Linear (default): times one band of
`--rows` rows (262,144) of a global linear score, as K8 over the whole
width (1,000,000 and 4,600,000 columns, seeded random DNA), with the
kernels of the older tree at DIR (at its own grid and at 462) and of this
tree (at its own grid). `--affine`: one such band of a local affine score
(2/-1/-3/-1) at 1,000,000 columns as K8 affine, and the same band as
K10 affine over 2 ranks of cuda:0 (each rank's first band of the mesh
score: half the columns a rank, both ranks at once, `share` 2, then each
rank's launch replayed alone), both trees at their own grids, and the
public calls that run them (the 1 Mbp local affine score on one card and
over 2 ranks of cuda:0, the 100k semiglobal affine ``align`` over 2 ranks
and on one card), each cold then warm. The runs go in turns (older, this,
this, older; each a process of its own that builds its tree's kernels),
and the outputs of all of them must be equal. Then this tree's K8
(4,600,000 columns) or K8 affine (900,000, 1,000,000 and 2,000,000; twice)
runs over the grids of `--sweep`: 0 is
the grid the kernel chooses, a number caps the grid, `N/sm` runs N warps
an SM spread over equal rounds, and `all` runs every strip at once where
the card holds them. Prints one JSON line a run, with the grid each
launch used where the tree's library reports it, and the medians with
their spreads and the card's name and power limit. A grid counts CTAs
of two warps in trees before the warp strip cores (``csrc/band_sweep.cuh``
for K8, ``csrc/band_sweep_affine.cuh`` for K8 affine), warps since.

`--check` first prints ptxas's registers and spills of the strip-sweep
sources and the DPX instructions (VIADDMNMX, VIMNMX3) in the SASS of the
warp cores, and holds this tree's K8, K10 and their affine modes to their
plain versions, as ``chip_smoke.py`` phases 1 and 2 do (3 modes, several
grids, 2 and 4 ranks of cuda:0).

    python3 tools/k8_ab.py --tree DIR --cols 1000000,4600000 [--grids 0]
                           [--affine]

is one such run: DIR's kernels (default: this tree), `--reps` times each
width and grid.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 262_144
WIDTHS = (1_000_000, 4_600_000)
AFFINE_WIDTH = 1_000_000
AFFINE = (2, -1, -3, -1)
SWEEP = "0,all,4/sm,8/sm,12/sm,16/sm,1320,924,660,462,264"
# K8 affine's grids at three widths where 12 warps an SM (12/sm) makes
# more rounds than the 16 its registers allow (16/sm, its own grid): 900 k
# (1,758 strips: 2 rounds against 1), 1 M (1,954: 2 against 1) and 2 M
# (3,907: 3 against 2)
AFFINE_SWEEP = "0,12/sm,16/sm,652"
AFFINE_SWEEP_WIDTHS = "900000,1000000,2000000"
OLDER_GRIDS = "0,462"       # the older tree's own grid, and its best cap


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def grid_size(spec: str, strips: int, sms: int, grid_of, rows: int,
              n: int, code: int) -> int:
    """The `grid` argument that a `--grids` entry stands for."""
    if spec == "all":
        return grid_of(rows, n, code, 1, strips)
    if spec.endswith("/sm"):
        rounds = -(-strips // (int(spec[:-3]) * sms))
        return -(-strips // rounds)
    return int(spec)


def checksum(out) -> list:
    """Sums of a band's outputs and its best, to hold runs equal."""
    return [int(out[k].long().sum()) for k in sorted(out) if k != "best"] \
        + out["best"].tolist()


def timed_runs(fn, reps: int):
    """`reps` runs of fn() timed with CUDA events, and the last output's
    checksum."""
    import torch

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


def run(tree: str, rows: int, widths, grids, reps: int,
        affine: bool) -> None:
    """One tree's bands; one JSON line each kernel, width and grid."""
    sys.path.insert(0, tree)
    import torch

    from anyseq_tpu_torch.core.types import (
        AffineScoring,
        LinearScoring,
        Mode,
        as_tensor,
    )
    from anyseq_tpu_torch.engine import affine as aff
    from anyseq_tpu_torch.engine import linmem
    from anyseq_tpu_torch.kernels import _build, band

    if not band.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {band.__file__}, not {tree}'s")
    lib = _build.library()
    # absent before the warp cores
    grid_of = getattr(lib, "anyseq_band_affine_grid" if affine
                      else "anyseq_band_grid", None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = as_tensor(bytes(alpha[rng.integers(0, 4, rows)]), "cuda")
    s_all = as_tensor(bytes(alpha[rng.integers(0, 4, max(widths))]), "cuda")
    dev = q.device
    code = 2 if affine else 0    # the C entries' LOCAL, GLOBAL
    if affine:
        sc, mode = AffineScoring(*AFFINE), Mode.LOCAL
        edge = aff.left_col_affine(mode, sc, 0, rows, False, dev)

        def k8(s, grid=0):
            return band.launch_affine(
                lib, q, s, *aff.top_row_affine(mode, sc, s.numel(), False,
                                               dev), *edge, mode, sc, grid)
    else:
        sc, mode = LinearScoring(), Mode.GLOBAL
        edge = linmem.left_col(mode, sc, 0, rows, dev)

        def k8(s, grid=0):
            return band.launch(lib, q, s, linmem.top_row(mode, sc, s.numel(),
                                                         dev), *edge, mode,
                               sc, grid)
    name = "K8 affine" if affine else "K8"
    # the strip width of the tree's kernel (trees before the affine warp
    # core swept K8 affine in band.STRIP-column strips too)
    strip = getattr(band, "AFFINE_STRIP", band.STRIP) if affine \
        else band.STRIP
    k8(s_all[:100_000].contiguous())     # warm-up
    for n in widths:
        s = s_all[:n].contiguous()
        strips = -(-n // strip)
        for spec in grids:
            if not grid_of and (spec == "all" or spec.endswith("/sm")):
                continue
            grid = grid_size(spec, strips, sms, grid_of, rows, n, code)
            runs, check = timed_runs(lambda: k8(s, grid), reps)
            used = grid_of(rows, n, code, 1, grid) if grid_of else None
            print(json.dumps({"tree": tree, "kernel": name, "rows": rows,
                              "cols": n, "grid": spec, "grid_used": used,
                              "runs_ms": runs,
                              "median_ms": float(np.median(runs)),
                              "check": check,
                              "after": smi("clocks.sm,power.draw,"
                                           "temperature.gpu")}), flush=True)
    if not affine or grids != ["0"]:
        return
    # K10 affine: each rank's first band of the 2-rank mesh score, both
    # ranks at once on this card; then the first run's launch of each rank
    # replayed alone (its halo already published)
    from anyseq_tpu_torch.dist import collective

    n = widths[0]
    s = s_all[:n].contiguous()
    ranks = collective.ranks_of(["cuda:0"] * 2)
    real, kept = band.launch_collective_affine, []

    def keeping(*args, **kwargs):
        kept.append(args)
        return real(*args, **kwargs)

    band.launch_collective_affine = keeping
    try:
        runs, check = timed_runs(lambda: collective.launch_pair(
            q, s, mode, sc, ranks, rows)(), reps)
    finally:
        band.launch_collective_affine = real
    Nl = collective.geometry(rows, n, 2, rows)[0]
    after = smi("clocks.sm,power.draw,temperature.gpu")
    lines = [("K10 affine 2 ranks", n, runs, check,
              grid_of(rows, Nl, code, 2, 0) if grid_of else None, after)]
    for rank, args in enumerate(kept[:2]):
        runs, check = timed_runs(lambda: real(*args), reps)
        lines.append((f"K10 affine rank {rank} alone", args[2].numel(), runs,
                      check, grid_of(rows, args[2].numel(), code, 1, 0)
                      if grid_of else None,
                      smi("clocks.sm,power.draw,temperature.gpu")))
    for kernel, cols, runs, check, used, after in lines:
        print(json.dumps({"tree": tree, "kernel": kernel, "rows": rows,
                          "cols": cols, "grid": "0", "grid_used": used,
                          "runs_ms": runs,
                          "median_ms": float(np.median(runs)),
                          "check": check, "after": after}), flush=True)
    end_to_end(tree, sc)


def end_to_end(tree: str, sc) -> None:
    """The public affine calls that run K8 affine or K10 affine, each
    twice (cold, then warm), host walls to the result: the 1 Mbp local
    score on one card and over 2 ranks of cuda:0, and the 100k
    semiglobal ``align`` over 2 ranks of cuda:0 and on one card."""
    import time

    import torch

    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch.dist.mesh import make_mesh
    from anyseq_tpu_torch.dist.sharded import score_pair_sharded
    from chip_smoke import related_pair

    rng = np.random.default_rng(7)
    q1, s1 = related_pair(rng, 1_000_000)
    q5, s5 = related_pair(rng, 100_000)
    mesh = make_mesh(devices=["cuda:0"] * 2)

    def mesh_score():
        out = score_pair_sharded(q1, s1, "local", sc, mesh)
        return out["best"].tolist()

    calls = (
        ("align_score 1 Mbp local affine",
         lambda: pt.align_score(q1, s1, "local", sc, device="cuda")),
        ("score_pair_sharded 1 Mbp local affine, 2 ranks of cuda:0",
         mesh_score),
        ("align(mesh=) 100k semiglobal affine, 2 ranks of cuda:0",
         lambda: pt.align(q5, s5, "semiglobal", sc, mesh=mesh).score),
        ("align 100k semiglobal affine",
         lambda: pt.align(q5, s5, "semiglobal", sc, device="cuda").score),
    )
    for name, fn in calls:
        walls, out = [], None
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append(round(time.perf_counter() - t0, 4))
        print(json.dumps({"tree": tree, "call": name, "walls_s": walls,
                          "check": out}), flush=True)


def check() -> int:
    """ptxas and SASS of this tree's strip sweeps; its K8, K10 and their
    affine modes against their plain versions (chip_smoke.py phase 1's
    report, phase 2's band and collective checks)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    cs.build_report()()
    rng = np.random.default_rng(cs.SEED)
    errors: dict = {}
    cs.phase2_band(rng, errors)
    cs.phase2_collective(rng, errors)
    print(f"check: K8, K10 and their affine modes equal to their plain "
          f"versions {errors}", flush=True)
    return 0


def ab(parent: str, rows: int, reps: int, sweep: str, affine: bool) -> int:
    """Older, this, this, older; then this tree's grid sweep."""
    print(smi("name,power.limit"), flush=True)
    lines = []
    if affine:
        cols, last, older = str(AFFINE_WIDTH), AFFINE_SWEEP_WIDTHS, "0"
    else:
        cols, last = ",".join(map(str, WIDTHS)), str(WIDTHS[-1])
        older = OLDER_GRIDS
    plan = [(parent, cols, older), (ROOT, cols, "0"), (ROOT, cols, "0"),
            (parent, cols, older), (ROOT, last, sweep)]
    if affine:
        plan.append((ROOT, last, sweep))
    for tree, widths, grids in plan:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree,
             "--rows", str(rows), "--cols", widths, "--grids", grids,
             "--reps", str(reps)] + (["--affine"] if affine else []),
            capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stderr.write(out.stderr)
            return out.returncode
        lines += [json.loads(x) for x in out.stdout.splitlines()]
    calls = [x for x in lines if "call" in x]
    lines = [x for x in lines if "kernel" in x]
    keys = {(x["kernel"], x["cols"]) for x in lines}
    checks = {(x["kernel"], x["cols"], json.dumps(x["check"]))
              for x in lines}
    call_checks = {(x["call"], json.dumps(x["check"])) for x in calls}
    if (len(checks) != len(keys)
            or len(call_checks) != len({x["call"] for x in calls})):
        print(f"k8_ab: outputs differ: {sorted(checks)} "
              f"{sorted(call_checks)}", file=sys.stderr)
        return 1
    print(f"medians ({smi('name,power.limit')}):")
    for kernel, n in sorted(keys):
        for spec in dict.fromkeys(x["grid"] for x in lines):
            for tree, name in ((parent, "older"), (ROOT, "this")):
                got = [x for x in lines if x["tree"] == tree
                       and x["kernel"] == kernel and x["cols"] == n
                       and x["grid"] == spec]
                runs = [r for x in got for r in x["runs_ms"]]
                if runs:
                    med = float(np.median(runs))
                    print(f"{kernel} {rows}x{n} grid={spec} "
                          f"({got[0]['grid_used']}) {name} tree: "
                          f"median_ms={med:.3f} "
                          f"spread={(max(runs) - min(runs)) / med:.3f} "
                          f"runs={runs}", flush=True)
    for call in dict.fromkeys(x["call"] for x in calls):
        for tree, name in ((parent, "older"), (ROOT, "this")):
            walls = [x["walls_s"] for x in calls
                     if x["tree"] == tree and x["call"] == call]
            if walls:
                print(f"{call} {name} tree: walls_s (cold, warm) {walls}",
                      flush=True)
    print("k8_ab ok: outputs equal")
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent")
    p.add_argument("--affine", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--tree", default=ROOT)
    p.add_argument("--rows", type=int, default=ROWS)
    p.add_argument("--cols")
    p.add_argument("--grids", default="0")
    p.add_argument("--sweep")
    p.add_argument("--reps", type=int, default=3)
    a = p.parse_args()
    if a.check and check():
        return 1
    if a.parent:
        return ab(os.path.abspath(a.parent), a.rows, a.reps,
                  a.sweep or (AFFINE_SWEEP if a.affine else SWEEP), a.affine)
    cols = a.cols or (str(AFFINE_WIDTH) if a.affine
                      else ",".join(map(str, WIDTHS)))
    run(os.path.abspath(a.tree), a.rows, [int(x) for x in cols.split(",")],
        a.grids.split(","), a.reps, a.affine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
