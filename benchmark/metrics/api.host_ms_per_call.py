"""api.host_ms_per_call: a public call's own span less the time its wait
spans cover (the host blocked on the card), in ms: the host's own work a
call (the program's spans, ``ANYSEQ_TIMING=1`` in the traced run's
window)."""
from benchmark import spans


def read(run):
    return spans.host_ms_per_call(spans.recorded())
