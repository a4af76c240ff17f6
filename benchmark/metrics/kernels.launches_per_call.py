"""kernels.launches_per_call: the port's own kernel launches a call (the
``launches`` of the program's call spans, its per-kernel launch counters
over the call), in the traced run's window; beside
engine.device_ops_per_call it tells the port's kernels from torch's."""
from benchmark import spans


def read(run):
    return spans.launches_per_call(spans.recorded())
