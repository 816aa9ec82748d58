"""``dispatch_ms.rt``: host ms a tile in the program's ``rt.dispatch`` spans,
each a stage's wait from the moment it became ready (submitted with no
dependency, or its last dependency done) to the moment its worker started
it (``runtime/manager.py``)."""
from rtbench.program_spans import host_ms, per_unit


def read(run):
    ms = host_ms(run, lambda name: name == "rt.dispatch")
    return per_unit(run, ms) if ms else None
