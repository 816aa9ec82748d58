"""``store_ms.rt``: ms a tile in the region stores' ``get`` and ``put`` (the
"DMS3" and "DMS2" backends; host copies, so synchronous)."""


def read(run):
    s = run.spans.get("store.get", []) + run.spans.get("store.put", [])
    if not s or not run.tally.completed:
        return None
    return 1e3 * sum(s) / run.tally.completed
