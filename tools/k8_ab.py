#!/usr/bin/env python3
"""K8 (``csrc/band.cu``) of two checkouts on one CUDA card, in turns.

    python3 tools/k8_ab.py --parent DIR [--check] [--rows 262144]
                           [--reps 3] [--sweep 0,all,8/sm,462]

DIR is an unpacked older tree. Times one band of `--rows` rows (262,144)
of a global linear score, as K8 over the whole width (1,000,000 and
4,600,000 columns, seeded random DNA), with the kernels of the older
tree at DIR (at its own grid and at 462) and of this tree (at its own
grid), in turns (older, this, this, older; each a process of its own
that builds its tree's kernels), and holds the outputs of all of them
equal. Then times this tree's K8 at 4,600,000 columns over the grids of
`--sweep`: 0 is the grid ``band.cu`` chooses, a number caps the grid,
`N/sm` runs N warps an SM spread over equal rounds, and `all` runs every
strip at once where the card holds them (the K10 ranks that share a
card each run a capped grid). Prints one JSON line a run, with the grid
each launch used where the tree's library reports it, and the medians
with their spreads and the card's name and power limit. A grid counts
CTAs of two warps in trees before the warp strip core
(``csrc/band_sweep.cuh``), warps since.

`--check` first holds this tree's K8 and K10 to their plain versions as
``chip_smoke.py`` phase 2 does (3 modes, several grids, 2 and 4 ranks of
cuda:0), and prints ptxas's registers and spills of ``band.cu`` and the
DPX instructions (VIADDMNMX, VIMNMX3) in its SASS.

    python3 tools/k8_ab.py --tree DIR --cols 1000000,4600000 [--grids 0]

is one such run: DIR's kernels (default: this tree), `--reps` times each
width and grid.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 262_144
WIDTHS = (1_000_000, 4_600_000)
SWEEP = "0,all,4/sm,8/sm,12/sm,16/sm,1320,924,660,462,264"
OLDER_GRIDS = "0,462"       # the older tree's own grid, and its best cap


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def grid_size(spec: str, strips: int, sms: int, grid_of, rows: int,
              n: int) -> int:
    """The `grid` argument that a `--grids` entry stands for."""
    if spec == "all":
        return grid_of(rows, n, 0, 1, strips)
    if spec.endswith("/sm"):
        rounds = -(-strips // (int(spec[:-3]) * sms))
        return -(-strips // rounds)
    return int(spec)


def run(tree: str, rows: int, widths, grids, reps: int) -> None:
    """One tree's K8 bands; one JSON line each width and grid."""
    sys.path.insert(0, tree)
    import torch

    from anyseq_tpu_torch.core.types import LinearScoring, Mode, as_tensor
    from anyseq_tpu_torch.engine import linmem
    from anyseq_tpu_torch.kernels import _build, band

    if not band.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {band.__file__}, not {tree}'s")
    lib = _build.library()
    grid_of = getattr(lib, "anyseq_band_grid", None)   # absent before
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sc, mode = LinearScoring(), Mode.GLOBAL
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = as_tensor(bytes(alpha[rng.integers(0, 4, rows)]), "cuda")
    s_all = as_tensor(bytes(alpha[rng.integers(0, 4, max(widths))]), "cuda")
    corner, col = linmem.left_col(mode, sc, 0, rows, q.device)
    warm = s_all[:100_000].contiguous()
    band.launch(lib, q, warm, linmem.top_row(mode, sc, warm.numel(),
                                             q.device), corner, col, mode, sc)
    for n in widths:
        s = s_all[:n].contiguous()
        row = linmem.top_row(mode, sc, n, q.device)
        strips = -(-n // 1024)
        for spec in grids:
            if not grid_of and (spec == "all" or spec.endswith("/sm")):
                continue
            grid = grid_size(spec, strips, sms, grid_of, rows, n)
            runs, check = [], None
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                out = band.launch(lib, q, s, row, corner, col, mode, sc,
                                  grid)
                end.record()
                torch.cuda.synchronize()
                runs.append(round(start.elapsed_time(end), 3))
                check = [int(out["last_row"].long().sum()),
                         int(out["last_col"].long().sum()),
                         *out["best"].tolist()]
                del out
            used = grid_of(rows, n, 0, 1, grid) if grid_of else None
            print(json.dumps({"tree": tree, "rows": rows, "cols": n,
                              "grid": spec, "grid_used": used,
                              "runs_ms": runs,
                              "median_ms": float(np.median(runs)),
                              "check": check,
                              "after": smi("clocks.sm,power.draw,"
                                           "temperature.gpu")}), flush=True)


def check() -> int:
    """ptxas and SASS of this tree's band.cu; its K8 and K10 against
    their plain versions (chip_smoke.py phase 2's band and collective
    checks)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from anyseq_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "band.so")
        out = subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", lib,
             str(_build.CSRC / "band.cu")], capture_output=True, text=True)
        if out.returncode:
            print(f"k8_ab: nvcc failed:\n{out.stderr}", file=sys.stderr)
            return 1
        ptxas = [x.split(":", 1)[-1].strip()
                 for x in (out.stdout + out.stderr).splitlines()
                 if "Used" in x or "spill" in x]
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", lib],
            capture_output=True, text=True, check=True).stdout
    dpx = {op: sass.count(op) for op in ("VIADDMNMX", "VIMNMX3")}
    print(f"band.cu: ptxas {ptxas} SASS DPX {json.dumps(dpx)}", flush=True)
    rng = np.random.default_rng(cs.SEED)
    errors: dict = {}
    cs.phase2_band(rng, errors)
    cs.phase2_collective(rng, errors)
    print(f"check: K8 and K10 equal to their plain versions {errors}",
          flush=True)
    return 0 if all(dpx.values()) else 1


def ab(parent: str, rows: int, reps: int, sweep: str) -> int:
    """Older, this, this, older; then this tree's grid sweep."""
    print(smi("name,power.limit"), flush=True)
    lines = []
    cols = ",".join(map(str, WIDTHS))
    plan = [(parent, cols, OLDER_GRIDS), (ROOT, cols, "0"),
            (ROOT, cols, "0"), (parent, cols, OLDER_GRIDS),
            (ROOT, str(WIDTHS[-1]), sweep)]
    for tree, widths, grids in plan:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree,
             "--rows", str(rows), "--cols", widths, "--grids", grids,
             "--reps", str(reps)],
            capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stderr.write(out.stderr)
            return out.returncode
        lines += [json.loads(x) for x in out.stdout.splitlines()]
    checks = {(x["cols"], json.dumps(x["check"])) for x in lines}
    if len(checks) != len({x["cols"] for x in lines}):
        print(f"k8_ab: outputs differ: {sorted(checks)}", file=sys.stderr)
        return 1
    print(f"medians ({smi('name,power.limit')}):")
    for n in WIDTHS:
        for spec in dict.fromkeys(x["grid"] for x in lines):
            for tree, name in ((parent, "older"), (ROOT, "this")):
                got = [x for x in lines if x["tree"] == tree
                       and x["cols"] == n and x["grid"] == spec]
                runs = [r for x in got for r in x["runs_ms"]]
                if runs:
                    med = float(np.median(runs))
                    print(f"K8 {rows}x{n} grid={spec} "
                          f"({got[0]['grid_used']}) {name} tree: "
                          f"median_ms={med:.3f} "
                          f"spread={(max(runs) - min(runs)) / med:.3f} "
                          f"runs={runs}", flush=True)
    print("k8_ab ok: outputs equal")
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent")
    p.add_argument("--check", action="store_true")
    p.add_argument("--tree", default=ROOT)
    p.add_argument("--rows", type=int, default=ROWS)
    p.add_argument("--cols", default=",".join(map(str, WIDTHS)))
    p.add_argument("--grids", default="0")
    p.add_argument("--sweep", default=SWEEP)
    p.add_argument("--reps", type=int, default=3)
    a = p.parse_args()
    if a.check and check():
        return 1
    if a.parent:
        return ab(os.path.abspath(a.parent), a.rows, a.reps, a.sweep)
    run(os.path.abspath(a.tree), a.rows, [int(x) for x in a.cols.split(",")],
        a.grids.split(","), a.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
