"""batch.stage_ms_per_call: the batch layer's staging a call, in ms: the
self time of its ``batch.stage`` spans (joining, bucketing, each chunk's
rows) and ``batch.copy_in`` spans (the copies to the card but their
waits), from the program's spans in the traced run's window."""
from benchmark import spans


def read(run):
    return spans.self_ms_per_call(spans.recorded(),
                                  ("batch.stage", "batch.copy_in"))
