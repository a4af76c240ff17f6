"""One run of one cell: set-up, the measured window, the traced calls, the
comparison with the plain reference and the result line.

Everything that belongs to one configuration, traffic mix, entry or
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json`` (the path in the configuration's ``file``):
  mode, scoring and sequence class with its sizes;
- ``traffic/<traffic>.json``: the entry called, the pool of calls' inputs,
  the pairs a call, the calls the traced run profiles, which calls are
  checked;
- ``entries/<entry>.py``: how the entry is called and what kind of answer
  it gives;
- ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader a
  metric, ``read(run)`` giving a number, or None where the run holds
  nothing for it to read (the metric is then left out of the line).

The window is a closed loop: one caller issues the next call when the
last has returned, cycling over the pool, until ``seconds`` have passed;
the call running at the deadline completes and counts.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from benchmark import bound, check, inputs, trace

HERE = Path(__file__).resolve().parent
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "anyseq_tpu")


@dataclass
class Cell:
    """A cell's entries of ``BENCHMARK.json`` and its files, resolved."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    base: Path = HERE


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "benchmark_file_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(root: Path, workload: str, base: Path = HERE) -> Cell:
    """The cell `workload` of ``root/BENCHMARK.json``; its traffic mixes,
    entries and metric readers are looked up under `base`."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{', '.join(sorted(cells))}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(workload, config, traffic, int(w["chips"]),
                [m for m in spec["end_to_end"] if _applies(m, workload)],
                [m for m in spec["per_layer"] if _applies(m, workload)],
                base)


@dataclass
class Run:
    """What the readers of a run's metrics read."""

    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0            # host clock, the whole closed loop
    calls: int = 0                   # calls that returned in the window
    failed: int = 0
    cells_done: int = 0              # m * n of every pair of those calls
    call_s: list = field(default_factory=list)
    window_peak_bytes: int | None = None
    timing_logs: list = field(default_factory=list)   # per window call
    gc_s: float = 0.0                # the cyclic collector in the window
    gc_runs: list = field(default_factory=lambda: [0, 0, 0])  # by generation
    profile: trace.Summary | None = None
    named: trace.Summary | None = None   # the trace that names idle gaps
    profiled_ops: float = 0.0        # the bound's work of the traced calls
    profiled_bytes: float = 0.0

    def phase_ms_per_call(self, *prefixes: str) -> float | None:
        """The summed times of the program's phase-log lines that start
        with one of `prefixes` ("<what> ... <n>ms"), a window call."""
        logs = [log for log in self.timing_logs if log]
        if not logs:
            return None
        return sum(float(x.rsplit(" ", 1)[1].removesuffix("ms"))
                   for log in logs for x in log
                   if x.startswith(prefixes)) / len(logs)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def scoring_of(program, config: dict):
    sc = config["scoring"]
    if sc["kind"] == "linear":
        return program.LinearScoring(sc["match"], sc["mismatch"], sc["gap"])
    if sc["kind"] == "affine":
        return program.AffineScoring(sc["match"], sc["mismatch"],
                                     sc["gap_open"], sc["gap_extend"])
    raise ValueError(f"unknown scoring kind {sc['kind']!r}")


def _work(item, answers, kind: str, per_cell: float) -> tuple[float, float]:
    """(int32 operations, bytes) of the bound for one call's inputs and
    answers: the cells, a walk step per constructed column; the inputs
    read once, the answers written once."""
    ops = item.cells * per_cell
    nbytes = sum(len(a) + len(b) for a, b in zip(item.queries,
                                                  item.subjects))
    if kind == "score":
        return ops, nbytes + 8 * len(item.queries)
    for a in answers:
        cols = len(a.query_aligned) - a.query_aligned.count(b" ")
        ops += cols * bound.WALK_STEP
        nbytes += 2 * len(a.query_aligned) + 12
    return ops, nbytes


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float | None = None):
    """(result, checks) of one run; `result` is the line's object but its
    ``checks``, which come last."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    import anyseq_tpu_torch as program

    cuda = device.startswith("cuda")
    config = cell.config
    entry = _load(cell.base / "entries" / f"{cell.traffic['entry']}.py")
    scoring = scoring_of(program, config)

    def call(item):
        return entry.call(program, item, config["mode"], scoring, device)

    pool = inputs.make_pool(config, cell.traffic, seed)
    for item in pool:      # every shape the window runs; answers are on the host
        call(item)
    run = Run(cell)
    run.setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    checked, attempted = _window(run, pool, call, seed, seconds, traced)
    if traced:
        # the calls of ``run.profile``, which are checked too
        outs = _profile(run, pool, call, cuda)
        per_cell = bound.ops_per_cell(config["mode"], config["scoring"])
        for slot, answers in outs:
            ops, nbytes = _work(pool[slot], answers, entry.KIND, per_cell)
            run.profiled_ops += ops
            run.profiled_bytes += nbytes
        checked += outs
        attempted += len(outs)
        if run.named is not run.profile:
            attempted += run.named.calls
    gc.unfreeze()
    peak = None
    if cuda:
        run.window_peak_bytes = torch.cuda.max_memory_allocated()
        peak = max(setup_peak, run.window_peak_bytes)
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    counts = _compare(cell, pool, checked, entry.KIND, device)
    counts["failed_calls"] = run.failed
    ref_s = time.perf_counter() - t_ref
    metrics = {}
    folder = "metrics" if traced else "end_to_end"
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = _load(cell.base / folder / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": check.passed(counts) and run.calls > 0,
        "attempted": attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": _device(run, peak, cuda),
        "window": {"seconds": run.window_s, "calls": run.calls,
                   "reference_s": ref_s,
                   "call_ms_quartiles": _quartiles_ms(run.call_s),
                   "gc_s": run.gc_s, "gc_runs": run.gc_runs},
    }
    if traced:
        result["window"]["traced_call_ms"] = _traced_call_ms(run)
    if run.profile is not None and run.profile.device_ops:
        result["breakdown"] = run.profile.breakdown()
    return result, check.lines(counts)


def _window(run: Run, pool, call, seed: int, seconds: float, traced: bool):
    """The closed loop over the pool for `seconds`; ([(pool index,
    answers)] to check, calls attempted). Checked are every call, or one
    a pool entry at a cycle drawn from the seed (the last call on it where
    the window ends before that cycle). The cyclic garbage collector is
    kept off what the set-up made and what is kept to check (frozen until
    the traced calls are done), so that it works on the calls' own objects
    only, as in a caller that keeps nothing; the collector's passes in the
    window are timed."""
    from anyseq_tpu_torch.engine import hirschberg

    P = len(pool)
    every = run.cell.traffic["checked_calls"] == "all"
    pick = inputs.rng_of(seed, 1).integers(0, 4, P)
    checked: list = []
    latest: dict = {}
    timing = traced and "ANYSEQ_TIMING" not in os.environ
    if timing:
        os.environ["ANYSEQ_TIMING"] = "1"
    gc_t0 = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            run.gc_s += time.perf_counter() - gc_t0[0]
            run.gc_runs[info["generation"]] += 1

    gc.collect()
    gc.freeze()
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    c = 0
    while True:
        ts = time.perf_counter()
        if ts >= deadline:
            break
        slot = c % P
        item = pool[slot]
        hirschberg.TIMING_LOG.clear()
        try:
            answers = call(item)
        except Exception as exc:      # a failed call counts, the loop goes on
            print(f"call {c} failed: {exc!r}", file=sys.stderr)
            run.failed += 1
            answers = None
        te = time.perf_counter()
        if answers is not None:
            run.calls += 1
            run.cells_done += item.cells
            run.call_s.append(te - ts)
            if timing:
                run.timing_logs.append(list(hirschberg.TIMING_LOG))
        if every or c // P == pick[slot]:
            checked.append((slot, answers))
            latest.pop(slot, None)
            gc.freeze()
        elif c // P < pick[slot]:
            latest[slot] = answers
            gc.freeze()
        c += 1
    run.window_s = time.perf_counter() - t0
    gc.callbacks.remove(on_gc)
    if timing:
        del os.environ["ANYSEQ_TIMING"]
    return checked + list(latest.items()), c


def _compare(cell: Cell, pool, checked, kind: str, device: str) -> dict:
    """The counts of `checked` answers against the reference, computed
    once a pool entry."""
    mode, sc = cell.config["mode"], cell.config["scoring"]
    counts = check.new_counts(kind)
    for slot in sorted({slot for slot, _ in checked}):
        item = pool[slot]
        ref_scores, ref_ends = check.reference_ends(item, mode, sc, device)
        for s2, answers in checked:
            if s2 == slot:
                check.compare(item, answers, ref_scores, ref_ends, mode, sc,
                              kind, counts, device)
    return counts


def _profile(run: Run, pool, call, cuda: bool):
    """Trace `profile_calls` whole calls, cycling over the pool, twice:
    with the device's activity alone into ``run.profile`` (busy time,
    operations, kernels, over the calls' wall on the host clock), then
    with the host's operations as well into ``run.named``, which only
    names the idle gaps (recording host operations slows the calls that
    it traces). [(pool index, answers)] of the calls of ``run.profile``.
    Without a card only the second pass runs, and is both."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = int(run.cell.traffic["profile_calls"])
    slots = [k % len(pool) for k in range(n)]
    outs = None
    if cuda:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            outs = [(k, call(pool[k])) for k in slots]
            wall = time.perf_counter() - t0
        run.profile = trace.device_summary(trace.device_events(prof), n,
                                           wall)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    named = []
    with profile(activities=activities) as prof:
        for k in slots:
            with record_function(trace.CALL_SPAN):
                named.append((k, call(pool[k])))
    run.named = trace.from_profiler(prof, n)
    if run.profile is None:
        run.profile = run.named
        return named
    run.profile.idle_by_host = run.named.idle_by_host
    return outs


def _traced_call_ms(run: Run) -> dict:
    """A call's mean wall in the window and in each traced pass, in ms:
    what tracing adds."""
    out = {"window": 1e3 * sum(run.call_s) / max(1, len(run.call_s))}
    if run.profile is not run.named:
        out["device_only"] = 1e3 * run.profile.window_s / run.profile.calls
    out["with_host_ops"] = 1e3 * run.named.window_s / run.named.calls
    return out


def _quartiles_ms(values) -> list:
    """min, quartiles and max of call times in ms (a diagnostic)."""
    if len(values) < 2:
        return [v * 1e3 for v in values]
    q = statistics.quantiles(values, n=4)
    return [min(values) * 1e3, *(x * 1e3 for x in q), max(values) * 1e3]


def _device(run: Run, peak, cuda: bool) -> dict:
    import torch

    out = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": run.cell.chips,
           "memory_peak_bytes": peak}
    if run.profile is not None:
        out["busy_s"] = run.profile.busy_s
        out["window_s"] = run.profile.window_s
    return out
