#!/usr/bin/env python3
"""K8 (``csrc/band.cu``) of two checkouts on one CUDA card, in turns.

    python3 tools/k8_ab.py --parent DIR     # DIR: an unpacked older tree

Times one band of 262,144 rows of a global linear score, as K8 over the
whole width (1,000,000 and 4,600,000 columns, seeded random DNA), with
the kernels of the older tree at DIR and of this tree, in turns (older,
this, this, older; each a process of its own that builds its tree's
kernels), and holds the outputs of all four equal. Then times this
tree's K8 at 4,600,000 columns with its grid capped at a few sizes (the
K10 ranks that share a card each run a capped grid). Prints one JSON
line a run, and the medians.

    python3 tools/k8_ab.py --tree DIR --cols 1000000,4600000 [--grids 0]

is one such run: DIR's kernels (default: this tree), `--reps` times each
width and grid (0: as many CTAs as fit on the card).
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
GRIDS = (0, 1320, 924, 660, 462, 264)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def run(tree: str, widths, grids, reps: int) -> None:
    """One tree's K8 bands; one JSON line each width and grid."""
    sys.path.insert(0, tree)
    import torch

    from anyseq_tpu_torch.core.types import LinearScoring, Mode, as_tensor
    from anyseq_tpu_torch.engine import linmem
    from anyseq_tpu_torch.kernels import _build, band

    if not band.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {band.__file__}, not {tree}'s")
    lib = _build.library()
    sc, mode = LinearScoring(), Mode.GLOBAL
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = as_tensor(bytes(alpha[rng.integers(0, 4, ROWS)]), "cuda")
    s_all = as_tensor(bytes(alpha[rng.integers(0, 4, max(widths))]), "cuda")
    corner, col = linmem.left_col(mode, sc, 0, ROWS, q.device)
    warm = s_all[:100_000].contiguous()
    band.launch(lib, q, warm, linmem.top_row(mode, sc, warm.numel(),
                                             q.device), corner, col, mode, sc)
    for n in widths:
        s = s_all[:n].contiguous()
        row = linmem.top_row(mode, sc, n, q.device)
        for grid in grids:
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
            print(json.dumps({"tree": tree, "rows": ROWS, "cols": n,
                              "grid": grid, "runs_ms": runs,
                              "median_ms": float(np.median(runs)),
                              "check": check,
                              "after": smi("clocks.sm,power.draw,"
                                           "temperature.gpu")}), flush=True)


def ab(parent: str, reps: int) -> int:
    """Older, this, this, older; then this tree's grid caps."""
    print(smi("name,power.limit"), flush=True)
    lines = []
    cols = ",".join(map(str, WIDTHS))
    plan = [(parent, "0"), (ROOT, "0"), (ROOT, "0"), (parent, "0"),
            (ROOT, ",".join(map(str, GRIDS)))]
    for tree, grids in plan:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree,
             "--cols", cols if grids == "0" else str(WIDTHS[-1]),
             "--grids", grids, "--reps", str(reps)],
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
    for n in WIDTHS:
        for grid in GRIDS:
            for tree, name in ((parent, "older"), (ROOT, "this")):
                runs = [r for x in lines if x["tree"] == tree
                        and x["cols"] == n and x["grid"] == grid
                        for r in x["runs_ms"]]
                if runs:
                    print(f"K8 {ROWS}x{n} grid={grid} {name} tree: "
                          f"median_ms={float(np.median(runs)):.3f} "
                          f"runs={runs}", flush=True)
    print("k8_ab ok: outputs equal")
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent")
    p.add_argument("--tree", default=ROOT)
    p.add_argument("--cols", default=",".join(map(str, WIDTHS)))
    p.add_argument("--grids", default="0")
    p.add_argument("--reps", type=int, default=2)
    a = p.parse_args()
    if a.parent:
        return ab(os.path.abspath(a.parent), a.reps)
    run(os.path.abspath(a.tree), [int(x) for x in a.cols.split(",")],
        [int(x) for x in a.grids.split(",")], a.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
