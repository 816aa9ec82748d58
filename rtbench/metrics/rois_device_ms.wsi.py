"""``rois_device_ms.wsi``: device ms a call of ``pipeline/wsi.py::extract_object_rois``,
between the CUDA events of the program's ``wsi.extract_object_rois`` span,
with no synchronise added around the call."""
from rtbench.program_spans import device_ms_a_call


def read(run):
    return device_ms_a_call(run, "wsi.extract_object_rois")
