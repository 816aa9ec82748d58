"""``segment_device_ms.plain``: device ms a call of ``pipeline/wsi.py::segment_tile``,
between the CUDA events of the program's ``wsi.segment_tile`` span (the
RGB's upload inside), with no synchronise added around the call."""
from rtbench.program_spans import device_ms_a_call


def read(run):
    return device_ms_a_call(run, "wsi.segment_tile")
