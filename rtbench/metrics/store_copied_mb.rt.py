"""``store_copied_mb.rt``: host MB a tile that the region stores copied, on
``put`` and on ``get`` (``repro_torch.storage.copies.stats()``). The counter
is the program's own, since its last read, so it holds the run's warm-up
images with its window: it is divided by the tiles of both. The read takes
the counter and clears it, so two runs of one process stay apart. A program
without the counter, and a run whose stores copied nothing, read None."""


def read(run):
    try:
        from repro_torch.storage import copies
    except ImportError:  # a program older than the counter
        return None
    counts = copies.stats()
    copies.reset_stats()
    moved = counts["put_bytes"] + counts["get_bytes"]
    t = run.traffic
    tiles = run.tally.completed + t.get("warm_images", 0) * t.get("tiles_per_image", 1)
    return 1e-6 * moved / tiles if moved and tiles else None
