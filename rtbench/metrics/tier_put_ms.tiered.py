"""``tier_put_ms.tiered``: host ms a tile in the program's ``tiers.put``
spans, the tiered stores' puts of the stages' Mask and Hema (the memory
tier, then the write-through to the DMS tier; ``storage/tiers.py``), summed
over the stage threads."""
from rtbench.program_spans import host_ms, per_unit


def read(run):
    ms = host_ms(run, lambda name: name == "tiers.put")
    return per_unit(run, ms) if ms else None
