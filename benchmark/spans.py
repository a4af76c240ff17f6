"""The program's own spans, reduced to the numbers of the per-layer
metrics that read them.

The program (``anyseq_tpu_torch.utils.profiling``) records a span tree
for each public call made while ``ANYSEQ_TIMING=1``, which the harness
sets for the traced run's window alone: its ``spans()`` then hold
exactly the window's calls. A span has a ``name``, ``start_ns`` /
``end_ns`` on the host clock, the index of its ``parent`` in the list (-1
for a call's own span, a root), the ``call`` it belongs to and its
``attrs``. Every number here is a sum over the window's calls divided by
the number of root spans. :func:`recorded` gives None (and so does each
reader) where the program records no spans, or dropped some.

Wait spans are those where the host blocks on the card: the ``*.wait``
spans, and the two copies to the host that wait as well as copy.
"""
from __future__ import annotations

from benchmark.trace import busy_us

WAITS = ("batch.copy_out", "hirschberg.result")


def recorded():
    """The program's recorded spans, or None (none recorded, some
    dropped, or a program that records none)."""
    try:
        from anyseq_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None or getattr(profiling, "dropped", 0):
        return None
    return read() or None


def is_wait(span) -> bool:
    return span.name.endswith(".wait") or span.name in WAITS


def _roots(spans) -> list:
    return [s for s in spans if s.parent < 0]


def _per_call(spans, total: float) -> float | None:
    roots = _roots(spans)
    return total / len(roots) if roots else None


def _ancestors(spans, span):
    p = span.parent
    while p >= 0:
        yield spans[p]
        p = spans[p].parent


def _waits_ns(spans, keep=lambda s: True) -> int:
    """The time the wait spans that `keep` admits cover, summed over the
    calls (no call's waits overlap another's)."""
    by_call: dict = {}
    for s in spans:
        if is_wait(s) and keep(s):
            by_call.setdefault(s.call, []).append((s.start_ns, s.end_ns))
    return sum(busy_us(iv) for iv in by_call.values())


def wait_ms_per_call(spans) -> float | None:
    """The time a call's wait spans cover, in ms."""
    if not spans:
        return None
    return _per_call(spans, _waits_ns(spans) / 1e6)


def host_ms_per_call(spans) -> float | None:
    """A call's span less the time its wait spans cover, in ms: the
    host's own work."""
    if not spans:
        return None
    total = sum(r.end_ns - r.start_ns for r in _roots(spans))
    return _per_call(spans, (total - _waits_ns(spans)) / 1e6)


def launches_per_call(spans) -> float | None:
    """The port's own kernel launches a call (the call spans'
    ``launches``)."""
    if not spans:
        return None
    roots = _roots(spans)
    if not roots or any("launches" not in r.attrs for r in roots):
        return None
    return _per_call(spans, sum(r.attrs["launches"] for r in roots))


def self_ms_per_call(spans, names) -> float | None:
    """The self time of the spans named in `names` (each one's interval
    less what its children cover), in ms; None where there is none."""
    if not spans:
        return None
    children: dict = {}
    for s in spans:
        if s.parent >= 0:
            children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    total, found = 0, False
    for i, s in enumerate(spans):
        if s.name in names:
            found = True
            total += (s.end_ns - s.start_ns) - busy_us(children.get(i, ()))
    return _per_call(spans, total / 1e6) if found else None


def ms_per_call(spans, name: str) -> float | None:
    """The summed time of the spans named `name`, in ms."""
    if not spans:
        return None
    found = [s.end_ns - s.start_ns for s in spans if s.name == name]
    return _per_call(spans, sum(found) / 1e6) if found else None


def attr_per_call(spans, names, attr: str) -> float | None:
    """The attribute `attr` of the spans named in `names`, summed."""
    if not spans:
        return None
    found = [s.attrs[attr] for s in spans if s.name in names]
    return _per_call(spans, sum(found)) if found else None


def waits_inside_ms_per_call(spans, name: str) -> float | None:
    """The time covered by the wait spans that lie inside a span named
    `name`, in ms."""
    if not spans or not any(s.name == name for s in spans):
        return None
    inside = _waits_ns(spans, lambda s: any(a.name == name for a in
                                            _ancestors(spans, s)))
    return _per_call(spans, inside / 1e6)
