"""``segment_ms.plain``: ms a call of ``pipeline/wsi.py::segment_tile``, a host
span that opens and closes on a device synchronise."""


def read(run):
    s = run.spans.get("segment_tile")
    return 1e3 * sum(s) / len(s) if s else None
