"""Connected component labeling on the card: wrapper of ``csrc/ccl.cu``.

Replaces ``repro.kernels.ccl.ccl_pallas`` (and its sweep kernel) with the
paper's union-find BWLabel, by tiles. The labels are canonical: each
component gets its minimum flat index, the background -1, as
``ref.ccl_unionfind_host`` gives.

A call is three launches on the current stream (``PHASES``): 32x32 tiles
labelled in shared memory (each also writing its edges as bit masks), the
unions across tile borders in device memory (which mark the tiles they
touch), and the compression of the marked tiles' labels to their roots.
``ref.ccl_blocked`` is the same decomposition in plain Python, for the
tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # calls that launched the kernels since the last reset
kernel_launches = 0  # device launches: three a call
PHASES = ("local", "border", "compress")


def ccl_cuda(mask: torch.Tensor, *, events: list | None = None) -> torch.Tensor:
    """(H, W) int32 mask (nonzero = foreground) -> (H, W) int32 labels.

    ``events``, if a list, receives four CUDA events that the kernel library
    records before the first phase and after each, for timing the phases one
    by one.
    """
    global launches, kernel_launches
    _build.require(mask, "ccl mask", torch.int32, 2)
    h, w = mask.shape
    if h * w >= 2**31:
        raise ValueError(f"ccl: {h}x{w} has flat indices beyond int32")
    labels = torch.empty_like(mask)
    kernels = _build.lib()
    scratch = torch.empty(kernels.rt_ccl_scratch_ints(h, w), dtype=torch.int32,
                          device=mask.device)
    handles = None if events is None else _build.event_handles(events, len(PHASES) + 1)
    with torch.cuda.device(mask.device):
        code = kernels.rt_ccl(mask.data_ptr(), labels.data_ptr(), scratch.data_ptr(), h, w,
                              handles, _build.stream(mask))
        with _build.counter_lock:
            launches += 1
            kernel_launches += len(PHASES)
    _build.check(code, "ccl")
    return labels
