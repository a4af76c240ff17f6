"""batch.assemble_ms_per_call: the time of the ``batch.assemble`` spans a
call, in ms: one ``Alignment`` a pair built from each chunk's results on
the host, from the program's spans in the traced run's window."""
from benchmark import spans


def read(run):
    return spans.ms_per_call(spans.recorded(), "batch.assemble")
