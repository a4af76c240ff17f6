"""The control of a cell's comparison: the plain reference put in the
program's place, computed in the integer type the configuration's
``control`` names (the nearest narrower type whose sums fail these
pairs), on the cell's own pool at its own size. It has to come out as
not correct: its counts are the upper readings of the cell's limits.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13

prints one JSON line a seed: the counts that the comparison deciding
``correct`` (``check.compare``) gives the control's answers against the
int32 reference, beside their limits, and ``correct`` as ``check.passed``
decides it. The control's answers are its scores, handed to the
comparison as a score entry's answers, and, where the entry constructs,
its end cells, compared as the construction's are. The benchmark's own
runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import check, harness, inputs  # noqa: E402


def control_counts(cell, seed: int, device: str) -> dict:
    """The comparison's counts of the control against the reference on
    every pool entry of `cell` for `seed`."""
    import torch

    config = cell.config
    mode, sc = config["mode"], config["scoring"]
    low = getattr(torch, config["control"]["dtype"])
    kind = harness._load(cell.base / "entries"
                         / f"{cell.traffic['entry']}.py").KIND
    counts = check.new_counts(kind)
    for item in inputs.make_pool(config, cell.traffic, seed):
        ref_scores, ref_ends = check.reference_ends(item, mode, sc, device)
        scores, ends = check.reference_ends(item, mode, sc, device, low)
        check.compare(item, scores.tolist(), ref_scores, ref_ends, mode, sc,
                      "score", counts)
        if kind == "alignment":
            check.count_ends(ends, np.ones(len(ends), bool), ref_ends,
                             counts)
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        counts = control_counts(cell, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cell.config["control"]["dtype"],
                          "correct": check.passed(counts),
                          "checks": check.lines(counts),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
