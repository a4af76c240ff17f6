"""Every place where a benchmark cell's public call blocks on the card, and
the wait span it lies in.

    python3 tools/sync_sites.py [--seed N] [--out chiprun_out/sync_sites.json]

Needs a CUDA device. For each cell of ``BENCHMARK.json``, one call on a
pool entry made from the seed, as the benchmark makes it: warm once, then
once under ``torch.cuda.set_sync_debug_mode("warn")`` with the program's
spans recorded (``ANYSEQ_TIMING=1``), catching each synchronising CUDA
operation that torch reports with the program's line that issued it and
the spans open at that moment (``utils/profiling.py``'s own stack). Then
once more with the spans off, to show that recording them adds no
synchronisation. Prints one line a site and exits 1 where a site lies
outside every wait span (``*.wait``, ``batch.copy_out``,
``hirschberg.result``) or the counts differ. Also times ``span()`` with
the switch off on this host.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import timeit
import traceback
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
PROGRAM = str(ROOT / "anyseq_tpu_torch")


def _site() -> str:
    """file:line of the innermost frame of the program on the stack."""
    for frame in reversed(traceback.extract_stack()):
        if frame.filename.startswith(PROGRAM) and not frame.filename.endswith(
                "profiling.py"):
            return (f"{os.path.relpath(frame.filename, ROOT)}:{frame.lineno} "
                    f"{frame.line}")
    return "outside the program"


def _syncs(call) -> list[tuple[str, tuple, bool]]:
    """(site, open spans, inside a wait) of each synchronisation that
    torch reports during `call()`."""
    import torch

    from anyseq_tpu_torch.utils import profiling

    found = []

    def hook(message, category, *args, **kwargs):
        if "synchronizing" in str(message):
            names = tuple(s.name for s in profiling._open)
            found.append((_site(), names, profiling._waiting > 0))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return found


def _off_cost_ns(n: int = 1_000_000) -> dict:
    """ns a ``with span(...)`` / ``with wait()`` block costs with the
    switch off, over an empty function call."""
    from anyseq_tpu_torch.utils import profiling

    def empty():
        pass

    def plain():
        with profiling.span("batch.sweep"):
            pass

    def attrs():
        with profiling.span("batch.sweep", pairs=5):
            pass

    def wait():
        with profiling.wait():
            pass

    base = min(timeit.repeat(empty, number=n, repeat=5))
    return {name: (min(timeit.repeat(f, number=n, repeat=5)) - base) / n * 1e9
            for name, f in (("span", plain), ("span_attrs", attrs),
                            ("wait", wait))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=2147483713)
    ap.add_argument("--out", default="chiprun_out/sync_sites.json")
    args = ap.parse_args(argv)

    import torch

    import anyseq_tpu_torch as program
    from benchmark import harness, inputs

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    report, bad = {"device": torch.cuda.get_device_name(0)}, 0
    # the first session of the debug mode reports one synchronisation of
    # its own, outside any call
    report["first_session"] = len(_syncs(lambda: None))
    for w in spec["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        entry = harness._load(cell.base / "entries"
                              / f"{cell.traffic['entry']}.py")
        sc = harness.scoring_of(program, cell.config)
        item = inputs.make_pool(cell.config, cell.traffic, args.seed)[0]

        def call():
            entry.call(program, item, cell.config["mode"], sc, "cuda")

        call()
        os.environ["ANYSEQ_TIMING"] = "1"
        try:
            on = _syncs(call)
        finally:
            del os.environ["ANYSEQ_TIMING"]
        off = _syncs(call)
        sites = Counter(on)
        outside = sum(c for (_, _, inside), c in sites.items() if not inside)
        bad += outside + (len(on) != len(off))
        report[w["name"]] = {
            "syncs": len(on), "syncs_spans_off": len(off),
            "outside_waits": outside,
            "sites": [{"site": site, "spans": list(names), "inside": inside,
                       "count": c}
                      for (site, names, inside), c in sites.items()]}
        print(f"{w['name']}: {len(on)} syncs ({len(off)} with spans off), "
              f"{outside} outside a wait span", flush=True)
        for (site, names, inside), c in sites.items():
            print(f"  {c:6d} x {'wait' if inside else 'NOT IN A WAIT'} "
                  f"{' > '.join(names[-2:])} | {site}", flush=True)
    report["off_cost_ns"] = _off_cost_ns()
    print("span() with the switch off, ns a block:", report["off_cost_ns"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
