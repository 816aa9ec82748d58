"""``sync_wait_ms.wsi``: host ms a tile in the program's ``sync.*`` spans,
the steps other than the input upload where the host waits for the card."""
from rtbench.program_spans import host_ms, per_unit


def read(run):
    return per_unit(run, host_ms(run, lambda name: name.startswith("sync.")))
