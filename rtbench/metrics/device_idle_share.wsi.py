"""``device_idle_share.wsi``: the share of the traced window with no kernel or copy on the
card (the profiler's trace), in %."""
from rtbench.trace import idle_share


def read(run):
    return idle_share(run)
