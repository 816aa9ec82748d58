"""``assemble_ms.rt``: host ms a tile in the program's ``dms.assemble`` spans,
where a region store's ``get`` builds its answer from the blocks it fetched
(a view of one block, or a copy into a fresh array)."""
from rtbench.program_spans import host_ms, per_unit


def read(run):
    ms = host_ms(run, lambda name: name == "dms.assemble")
    return per_unit(run, ms) if ms else None
