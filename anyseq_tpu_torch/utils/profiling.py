"""Timing and throughput lines, a profiler trace, and the program's spans.

The counterpart of the JAX package's ``utils/profiling.py``: a wall-clock
timer with the reference's semantics, a context manager that prints the
reference's "testing <name> N ms" line (plus GCUPS for a cell count), and
a trace of the block for offline reading, here ``torch.profiler``'s
Chrome trace (host and, with a card, device activity) where the JAX
package takes a ``jax.profiler`` trace.

Spans. Each public entry runs inside its call span (:func:`entry`), and
its layers inside :func:`span` and :func:`wait`: named intervals of the
host clock (``time.perf_counter_ns``), each with its parent, the call it
belongs to and a few attributes (pairs, parts, bytes, kernel launches).
They are recorded only where ``ANYSEQ_TIMING=1`` is in the environment
when the outermost public call starts (read once a call); :func:`spans`
returns them and :func:`clear` forgets them. Nothing is written to disk.
While a ``torch.profiler`` profile is active, with the switch or without
it, every span is also a ``record_function`` range, so that the
profiler's timeline (and :func:`trace`'s Chrome trace) shows the
program's spans around the torch operations, copies and kernels they
issue, on the profiler's clock. With the switch off and no profile
active a span is one shared object that does nothing.

A wait span covers a place where the host blocks on the card: a copy to
the host, a Python value read from a device tensor, a copy from pageable
host memory (which waits for the stream's earlier work). It is named
after the layer of the span it lies in (``<layer>.wait``); the spans of
:data:`WAITS` wait as well as copy. A wait inside a wait is not recorded
again. A span's end never waits for the card: on a CUDA device the time
between two waits is the host's enqueue, not the device's work.

One thread makes the public calls of a process: the span state is the
module's.

CUDA work is asynchronous: a block timed here should end in something
that waits for the card (a result copied to the host, or
``torch.cuda.synchronize()``), as the public calls do.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# spans kept at most; later ones are counted in ``dropped``
MAX_SPANS = 1 << 17
# spans, besides the ``*.wait`` ones, during which the host waits for the
# card: the copies of a batch chunk's results and of a construction's
# strings to the host
WAITS = frozenset({"batch.copy_out", "hirschberg.result"})

_on = False        # recording: ANYSEQ_TIMING=1 at the outermost call's start
_calls = 0         # public calls open (recorded or not)
_call_id = 0       # the recorded call the open spans belong to
_waiting = 0       # wait spans open
_open: list = []   # open spans, outermost first
_spans: list = []
dropped = 0


class Span:
    """One span: its `name`, host-clock `start_ns` / `end_ns`
    (``time.perf_counter_ns``), the index in :func:`spans` of its
    `parent` (-1 for a public call's own span), the id of the `call` it
    belongs to and its `attrs`."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "attrs",
                 "index", "_wait", "_range")

    def __init__(self, name: str, attrs: dict, wait: bool = False):
        self.name = name
        self.attrs = attrs
        self._wait = wait
        self.parent = self.index = -1
        self.call = 0
        self._range = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self):
        global dropped, _waiting
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if _on:
            self.parent = _open[-1].index if _open else -1
            self.call = _call_id
            if len(_spans) < MAX_SPANS:
                self.index = len(_spans)
                _spans.append(self)
            else:
                dropped += 1
        _open.append(self)
        _waiting += self._wait
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _waiting
        self.end_ns = time.perf_counter_ns()
        _waiting -= self._wait
        _open.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


class _Off:
    """The span of a program that records nothing and is not profiled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager: the span `name` of the enclosed block, with
    `attrs`; the shared no-op where nothing records or profiles."""
    if _on or _autograd_profiler._is_profiler_enabled:
        return Span(name, attrs, name in WAITS)
    return _OFF


def wait():
    """A context manager around a place where the host blocks on the
    card: the span ``<layer>.wait``, `layer` that of the innermost open
    span; nothing inside another wait."""
    if not (_on or _autograd_profiler._is_profiler_enabled) or _waiting:
        return _OFF
    layer = _open[-1].name.partition(".")[0] if _open else "program"
    return Span(layer + ".wait", {}, True)


def _launches() -> int:
    from anyseq_tpu_torch.kernels import _build

    return sum(_build.launches.values())


class _Call:
    """The span of one call of a public entry (see :func:`entry`)."""

    __slots__ = ("name", "span", "root", "launches0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _on, _call_id, _calls
        self.root = not _calls
        if self.root:
            _on = os.environ.get("ANYSEQ_TIMING") == "1"
            _call_id += _on
        _calls += 1
        self.span = span(self.name)
        self.launches0 = _launches() if _on else 0
        return self.span.__enter__()

    def __exit__(self, *exc):
        global _on, _calls
        if _on:
            self.span.attrs["launches"] = _launches() - self.launches0
        self.span.__exit__(*exc)
        _calls -= 1
        if self.root:
            _on = False
        return False


def entry(name: str):
    """Decorator of a public entry: each call runs inside the span `name`.
    The outermost call reads ``ANYSEQ_TIMING`` once for the whole call and
    starts a new call id; a public entry called inside another is a child
    span of its caller. Each recorded call span has the attribute
    ``launches``: the port's own kernel launches
    (``kernels/_build.launches``) during it."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with _Call(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def recording() -> bool:
    """Whether the open call records its spans (``ANYSEQ_TIMING=1``)."""
    return _on


def spans() -> list[Span]:
    """The recorded spans, in the order they started (a copy of the
    list; a span's ``parent`` indexes it)."""
    return list(_spans)


def clear() -> None:
    """Forget the recorded spans and the dropped count (between calls)."""
    global dropped
    _spans.clear()
    dropped = 0


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
    ``log_dir/trace.json`` (open it in chrome://tracing or Perfetto). The
    program's spans are in it as ``record_function`` ranges, around the
    operations they issue."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
