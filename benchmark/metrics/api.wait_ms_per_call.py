"""api.wait_ms_per_call: the time a public call's wait spans cover, in ms:
the host blocked on the card (copies to the host, values read from the
card, copies from pageable memory), from the program's spans in the
traced run's window."""
from benchmark import spans


def read(run):
    return spans.wait_ms_per_call(spans.recorded())
