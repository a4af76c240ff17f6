"""Spreads of result lines, as the benchmark's bounds are set from them.

    python3 benchmark/spread.py FILE [FILE ...]

Each FILE holds runs' standard output; the last JSON object with
``metrics`` on each line counts as one run. Runs are grouped by file.
For each metric: the runs' values, the median, and the spread, the
distance between the first and third quartiles (``statistics.quantiles``
with n=4) as a share of the median.
"""
import json
import statistics
import sys


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def runs(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{") and '"metrics"' in line:
                out.append(json.loads(line))
    return out


def main(paths) -> int:
    for path in paths:
        rs = runs(path)
        print(f"{path}: {len(rs)} runs, correct {sum(r['correct'] for r in rs)}")
        names = sorted({k for r in rs for k in r["metrics"]})
        for name in names:
            vals = [r["metrics"][name]["value"] for r in rs
                    if name in r["metrics"]]
            line = f"  {name}: median {statistics.median(vals)!r}"
            if len(vals) >= 2:
                line += f" spread {spread(vals):.4%}"
            print(line + f" values {vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
