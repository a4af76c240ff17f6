"""hirschberg.levels_wait_ms_per_call: the time the wait spans inside the
Hirschberg driver's ``hirschberg.level`` spans cover a call, in ms: the
levels' host blocked on the card (the lists copied to it, the split rows
read back), from the program's spans in the traced run's window."""
from benchmark import spans


def read(run):
    return spans.waits_inside_ms_per_call(spans.recorded(),
                                          "hirschberg.level")
