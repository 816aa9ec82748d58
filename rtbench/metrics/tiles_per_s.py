"""``tiles_per_s``: 4096^2 tiles analysed (labels and features on the host)
over the whole window, on the host clock."""


def read(run):
    if run.unit != "tile" or run.window_s <= 0:
        return None
    return run.tally.completed / run.window_s
