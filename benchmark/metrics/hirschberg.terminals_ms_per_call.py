"""hirschberg.terminals_ms_per_call: the Hirschberg driver's terminal
stripes (pred sweeps and walks), their wall a call (the program's own
phase log, ``ANYSEQ_TIMING=1``, in whole ms), averaged over the window's
calls of the traced run."""


def read(run):
    return run.phase_ms_per_call("terminals ", "aff terminals ")
