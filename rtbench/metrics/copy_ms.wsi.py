"""``copy_ms.wsi``: device ms a tile of host-to-device and device-to-host
copies, from the profiler's trace."""


def read(run):
    if run.trace is None or not run.tally.completed:
        return None
    c = run.trace["copy_s"]
    s = c.get("HtoD", 0.0) + c.get("DtoH", 0.0)
    return 1e3 * s / run.tally.completed if s > 0 else None
