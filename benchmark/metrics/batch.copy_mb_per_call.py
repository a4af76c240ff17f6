"""batch.copy_mb_per_call: the bytes the batch layer copies to the card
and back a call (the ``bytes`` of its ``batch.copy_in`` and
``batch.copy_out`` spans), in MB of 10^6 bytes, in the traced run's
window."""
from benchmark import spans


def read(run):
    n = spans.attr_per_call(spans.recorded(),
                            ("batch.copy_in", "batch.copy_out"), "bytes")
    return None if n is None else n / 1e6
