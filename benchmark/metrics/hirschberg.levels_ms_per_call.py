"""hirschberg.levels_ms_per_call: the Hirschberg driver's divide levels,
their wall a call (the program's own phase log, ``ANYSEQ_TIMING=1``,
each level's line in whole ms), averaged over the window's calls of the
traced run."""


def read(run):
    return run.phase_ms_per_call("level ", "aff level ")
