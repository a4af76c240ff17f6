"""What the A/B tools (``tools/k1_ab.py``, ``k4_ab.py``, ``walk_ab.py``,
``k7_probe.py``) share: the card's state, one JSON line a measurement, a
tree's package imported with its kernels built, each run a process of its
own, two trees run in turns with their outputs held equal, and the median
and spread of a group of runs.

A tool imports it as ``_ab``: a script's own directory is first on
``sys.path``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np


def smi(query: str) -> str:
    """nvidia-smi's csv answer to --query-gpu=`query`."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def emit(**line) -> None:
    """Print one measurement as a JSON line, with the card's clock, power
    and temperature after it and the median of its runs."""
    line["after"] = smi("clocks.sm,power.draw,temperature.gpu")
    if "runs_ms" in line:
        line["median_ms"] = float(np.median(line["runs_ms"]))
    print(json.dumps(line), flush=True)


def import_tree(tree: str):
    """The tree's package, its kernels built."""
    sys.path.insert(0, tree)
    from anyseq_tpu_torch.kernels import _build

    if not _build.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {_build.__file__}, not {tree}'s")
    return _build.library()


def timed_runs(fn, reps: int, kernel: str, checksum, digits: int = 3):
    """After one warm-up, `reps` runs of fn() under torch.profiler: each
    run's device time (ms) of the kernel whose name holds `kernel`; then
    `reps` runs timed with CUDA events around the wrapper's call (its host
    work included); and checksum() of the last output."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile now and then catches no kernel: again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        runs = [round((e.time_range.end - e.time_range.start) / 1e3, digits)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.name]
        if len(runs) == reps:
            break
    else:
        raise RuntimeError(f"profiler saw {len(runs)} {kernel} kernels of "
                           f"{reps} runs")
    calls, check = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        calls.append(round(start.elapsed_time(end), digits))
        check = checksum(out)
        del out
    return runs, calls, check


def host_runs(fn, reps: int, digits: int = 3) -> list:
    """`reps` runs of fn() timed on the host's clock (ms) from the call to
    its return, the card idle before each: the wrapper's host work, with
    its launches but not what they run."""
    import time

    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append(round((time.perf_counter() - t0) * 1e3, digits))
    torch.cuda.synchronize()
    return out


def child(script: str, args) -> list:
    """Run `script` with `args` in a process of its own; its JSON lines
    (its output is passed on; a failure ends this process too)."""
    out = subprocess.run([sys.executable, os.path.abspath(script), *args],
                         capture_output=True, text=True)
    sys.stdout.write(out.stdout)
    if out.returncode:
        sys.stderr.write(out.stderr)
        raise SystemExit(out.returncode)
    return [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith("{")]


def equal_outputs(lines, key_of, tool: str) -> bool:
    """Each measurement's outputs (its `check`) equal across its runs."""
    seen: dict = {}
    for x in lines:
        seen.setdefault(key_of(x), set()).add(json.dumps(x["check"]))
    bad = {k: v for k, v in seen.items() if len(v) > 1}
    if bad:
        print(f"{tool}: outputs differ: {bad}", file=sys.stderr)
    return not bad


def in_turns(script: str, root: str, parent: str, reps: int, key_of,
             tool: str, extra=()):
    """`script --tree` (and the arguments `extra`) of the older tree
    `parent` and of `root`, each a process of its own, in turns: older,
    this, this, older. Their lines, each marked ``which`` (older / this);
    None where outputs differ."""
    lines = []
    for tree in (parent, root, root, parent):
        lines += child(script, ["--tree", tree, "--reps", str(reps),
                                *extra])
    if not equal_outputs(lines, key_of, tool):
        return None
    for x in lines:
        x["which"] = "older" if x["tree"] == parent else "this"
    return lines


def grouped(lines, key_of, group_of):
    """(measurement, group, its lines) of `lines`, in first-seen order."""
    for key in dict.fromkeys(key_of(x) for x in lines):
        got = [x for x in lines if key_of(x) == key]
        for g in dict.fromkeys(group_of(x) for x in got):
            yield key, g, [x for x in got if group_of(x) == g]


def stats(sel, digits: int = 3):
    """(median, text) of a group's device runs: the median, the spread
    (max - min over the median), the runs and, where the lines keep them,
    the median of the calls timed with CUDA events and of their host work
    (``host_runs``)."""
    runs = [r for x in sel for r in x["runs_ms"]]
    med = float(np.median(runs))
    text = (f"median_ms={med:.{digits}f} "
            f"spread={(max(runs) - min(runs)) / med:.3f} runs={runs}")
    if "call_ms" in sel[0]:
        call = float(np.median([r for x in sel for r in x["call_ms"]]))
        text += f" call_median_ms={call:.{digits}f}"
    if "host_ms" in sel[0]:
        host = float(np.median([r for x in sel for r in x["host_ms"]]))
        text += f" host_median_ms={host:.{digits}f}"
    return med, text
