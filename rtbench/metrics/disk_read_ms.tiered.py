"""``disk_read_ms.tiered``: host ms a tile in the program's ``disk.get``
spans, the DISK tier's reads of the tiles' RGB (``storage/disk.py``: the
file read, the view), summed over the stage threads."""
from rtbench.program_spans import host_ms, per_unit


def read(run):
    ms = host_ms(run, lambda name: name == "disk.get")
    return per_unit(run, ms) if ms else None
