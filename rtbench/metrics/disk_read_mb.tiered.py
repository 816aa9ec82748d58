"""``disk_read_mb.tiered``: MB a tile that the tiered stores' DISK tiers read
over the window, from the program's counters (``TieredStore.counters``,
``<store>.DISK.bytes_read``, differenced over the window by the harness).
One RGB tile is 201.33 MB. A program without the counters, and a run that
completed no tile, read None."""


def read(run):
    keys = [k for k in run.counters if k.endswith(".DISK.bytes_read")]
    if not keys or not run.tally.completed:
        return None
    return 1e-6 * sum(run.counters[k] for k in keys) / run.tally.completed
