"""``upload_ms.wsi``: host ms a tile in the program's ``wsi.upload`` spans,
the pageable host-to-card copies of the tile's inputs that the host waits
for (staging and page faults with the copy)."""
from rtbench.program_spans import host_ms, per_unit


def read(run):
    return per_unit(run, host_ms(run, lambda name: name == "wsi.upload"))
