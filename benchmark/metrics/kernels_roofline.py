"""kernels_roofline: the bound of the traced calls' work (benchmark/bound.py:
the larger of their int32 operations over the card's peak and their bytes
over its memory rate) over the summed device time of every kernel that
ran in them, in %."""
from benchmark import bound


def read(run):
    p = run.profile
    if p is None or p.kernel_s <= 0 or run.profiled_ops <= 0:
        return None
    t, _ = bound.bound_seconds(run.profiled_ops, run.profiled_bytes)
    return 100.0 * t / p.kernel_s
