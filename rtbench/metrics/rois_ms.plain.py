"""``rois_ms.plain``: ms a call of ``pipeline/wsi.py::extract_object_rois``, a
host span that opens and closes on a device synchronise."""


def read(run):
    s = run.spans.get("extract_object_rois")
    return 1e3 * sum(s) / len(s) if s else None
