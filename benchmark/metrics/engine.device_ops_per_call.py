"""engine.device_ops_per_call: device kernels, copies and memsets a traced
call (torch.profiler)."""


def read(run):
    p = run.profile
    if p is None or not p.device_ops:
        return None
    return p.device_ops / p.calls
