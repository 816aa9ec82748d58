"""``host_syncs.wsi``: host-device synchronisations a tile, counted as the
program's ``wsi.upload`` and ``sync.*`` spans."""
from rtbench.program_spans import is_sync, per_unit, records


def read(run):
    return per_unit(run, [1 for r in records(run) if is_sync(r.name)])
