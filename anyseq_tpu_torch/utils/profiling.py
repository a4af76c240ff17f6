"""Timing and throughput lines, and a profiler trace.

The counterpart of the JAX package's ``utils/profiling.py``: a wall-clock
timer with the reference's semantics, a context manager that prints the
reference's "testing <name> N ms" line (plus GCUPS for a cell count), and
a trace of the block for offline reading, here ``torch.profiler``'s
Chrome trace (host and, with a card, device activity) where the JAX
package takes a ``jax.profiler`` trace.

CUDA work is asynchronous: a block timed here should end in something
that waits for the card (a result copied to the host, or
``torch.cuda.synchronize()``), as the public calls do.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch


class Timer:
    """Wall-clock timer, the reference's ``am::timer`` semantics: start
    and stop add up across intervals."""

    def __init__(self):
        self._t0 = None
        self.elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        if self._t0 is not None:
            self.elapsed += time.perf_counter() - self._t0
            self._t0 = None
        return self

    def milliseconds(self) -> int:
        return int(round(self.elapsed * 1000))


@contextlib.contextmanager
def timed(name: str, cells: int | None = None, file=None, emit_json=False):
    """Time a block; prints "testing <name> N ms" plus GCUPS when a cell
    count is given (or, with ``emit_json``, one JSON object)."""
    out = file or sys.stdout
    t = Timer().start()
    yield t
    t.stop()
    if emit_json:
        rec = {"name": name, "ms": t.milliseconds()}
        if cells:
            rec["gcups"] = round(cells / max(t.elapsed, 1e-12) / 1e9, 3)
        print(json.dumps(rec), file=out)
    else:
        line = f"testing {name} {t.milliseconds()} ms"
        if cells:
            line += f" ({cells / max(t.elapsed, 1e-12) / 1e9:.2f} GCUPS)"
        print(line, file=out)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and the card
    where there is one) and write its Chrome trace to
    ``log_dir/trace.json`` (open it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
