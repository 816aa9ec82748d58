"""``tile_mfu``: the least time the card could take for a tile over the
window's time a tile, in %. The least time is the RGB read once and the
labels, boxes and features written once at the HBM rate: work-based, so it
holds whatever implements the tile."""


def read(run):
    if run.unit != "tile" or not run.tally.completed:
        return None
    w = run.config["wsi"]
    hw = w["tile"] * w["tile"]
    nbytes = 3 * hw * 4 + hw * 4 + w["max_objects_per_tile"] * (9 + 4) * 4
    least = nbytes / run.peaks["hbm_bytes_per_s"]
    return 100.0 * least * run.tally.completed / run.window_s
