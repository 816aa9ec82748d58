"""``setup_s``: process start to the first timed request (loading, the tile
pool, the program's stores, warm-up), on the host clock."""


def read(run):
    return run.setup_s
