"""device.idle_pct: the share of a call's wall in which no kernel, copy or
memset ran on the device: the traced calls' busy time a call (the union
of their device intervals, from a trace of the device's activity alone)
over the window's time a call (host clock, the whole window over its
calls). The traced calls' own wall is not the divisor: once a process
has been traced its calls run slower, traced or not."""


def read(run):
    p = run.profile
    if p is None or not p.device_ops or not run.calls or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - (p.busy_s / p.calls) / (run.window_s / run.calls))
