"""Reduction of ``torch.profiler`` traces of whole calls to the numbers
the per-layer metrics read: device intervals and their union over the
calls' wall, from a trace of the device's activity alone; the idle gaps
between them named by what the host was doing, from a trace that records
the host's operations too (which slows the calls); and the device
operations that took most time.

Only summaries leave this module; no trace is written to disk.
"""
from __future__ import annotations

from dataclasses import dataclass, field

CALL_SPAN = "benchmark.call"


def busy_us(spans) -> float:
    """Union of the (start, end) intervals, in their unit.

    Frozen copy of ``tools/profile_torch.py`` ``busy_ms`` (which divides
    by 1e3 for milliseconds)."""
    total, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def merged(spans) -> list[tuple[float, float]]:
    """The union of the intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class Summary:
    """What a trace of `calls` whole calls gives (times in seconds)."""

    calls: int
    window_s: float = 0.0          # first call's start to last call's end
    busy_s: float = 0.0            # union of device intervals in it
    kernel_s: float = 0.0          # summed time of every device kernel
    device_ops: int = 0            # kernels, copies and memsets
    by_name: dict = field(default_factory=dict)     # device s by op name
    idle_by_host: dict = field(default_factory=dict)  # gap s by host op

    def breakdown(self, top: int = 10) -> dict:
        def biggest(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    [:top]]
        return {"device_ops": biggest(self.by_name),
                "idle_gaps": biggest(self.idle_by_host)}


def _innermost(host, points):
    """For each time in `points` (sorted), a name for what the host was
    doing then, from `host`: (start, end, name) of one thread, properly
    nested. The innermost event that spans the time; where that is a
    call's span itself (Python of the program, between torch operations),
    "python before " the next event that starts."""
    names, stack, k = [], [], 0
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    for t in points:
        while k < len(host) and host[k][0] <= t:
            while stack and stack[-1][1] <= host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        name = stack[-1][2] if stack else "no host op"
        if name == CALL_SPAN and k < len(host):
            name = "python before " + host[k][2]
        names.append(name)
    return names


def device_summary(device, calls: int, wall_s: float) -> Summary:
    """`device`: (start_us, end_us, name, is_kernel) of every device
    operation of `calls` whole calls whose wall, on the host clock, was
    `wall_s`: a trace of the device's activity alone."""
    out = Summary(calls, window_s=wall_s)
    _add_device(out, device)
    return out


def _add_device(out: Summary, device) -> None:
    out.busy_s = busy_us([(a, b) for a, b, _, _ in device]) / 1e6
    out.device_ops = len(device)
    for a, b, name, kern in device:
        out.by_name[name] = out.by_name.get(name, 0.0) + (b - a) / 1e6
        if kern:
            out.kernel_s += (b - a) / 1e6


def summarize(device, host, calls: int) -> Summary:
    """`device`: (start_us, end_us, name, is_kernel) of every device
    operation; `host`: (start_us, end_us, name, thread) of every host
    event, among them one ``CALL_SPAN`` a profiled call."""
    spans = [(a, b) for a, b, name, _ in host if name == CALL_SPAN]
    out = Summary(calls)
    if not spans or not device:
        return out
    lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
    dev = [(max(a, lo), min(b, hi), name, kern) for a, b, name, kern in device
           if b > lo and a < hi]
    out.window_s = (hi - lo) / 1e6
    _add_device(out, dev)
    threads = {t for _, _, name, t in host if name == CALL_SPAN}
    main = [(a, b, name) for a, b, name, t in host if t in threads]
    edges = [lo] + [x for iv in merged([(a, b) for a, b, _, _ in dev])
                    for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    mids = [(a + b) / 2 for a, b in gaps]
    for (a, b), name in zip(gaps, _innermost(main, mids)):
        out.idle_by_host[name] = out.idle_by_host.get(name, 0.0) + (b - a) / 1e6
    return out


def device_events(prof) -> list:
    """(start_us, end_us, name, is_kernel) of every device operation of a
    finished ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.events():
        if e.device_type != cuda or e.name == CALL_SPAN or getattr(
                e, "is_user_annotation", False):
            continue            # a call's span, mirrored on the device
        name = e.name
        kern = not (name.startswith("Memcpy") or name.startswith("Memset"))
        out.append((e.time_range.start, e.time_range.end, name, kern))
    return out


def from_profiler(prof, calls: int) -> Summary:
    """Summary of a finished ``torch.profiler.profile`` that recorded the
    host's operations, one ``CALL_SPAN`` a call."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host = [(e.time_range.start, e.time_range.end, e.name, e.thread)
            for e in prof.events() if e.device_type != cuda]
    return summarize(device_events(prof), host, calls)
