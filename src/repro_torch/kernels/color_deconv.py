"""Color deconvolution on the card: wrapper of ``csrc/color_deconv.cu``.

Replaces ``repro.kernels.color_deconv.color_deconv_pallas``. The plain
version is ``ref.color_deconv_ref``; ``ops.color_deconv`` picks between them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset


def color_deconv_cuda(rgb: torch.Tensor, minv: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(3, H, W) float32 in [0,1] -> (3, H, W) stain densities, on the card.

    ``minv`` is the (3, 3) float32 stain inverse on the same device.
    """
    global launches
    _build.require(rgb, "color_deconv rgb", torch.float32, 3)
    _build.require(minv, "color_deconv minv", torch.float32, 2)
    if rgb.shape[0] != 3 or tuple(minv.shape) != (3, 3):
        raise ValueError(f"color_deconv: want (3, H, W) and (3, 3), got "
                         f"{tuple(rgb.shape)} and {tuple(minv.shape)}")
    if minv.device != rgb.device:
        raise ValueError(f"color_deconv: minv on {minv.device}, rgb on {rgb.device}")
    out = torch.empty_like(rgb)
    with torch.cuda.device(rgb.device):
        code = _build.lib().rt_color_deconv(
            rgb.data_ptr(), minv.data_ptr(), out.data_ptr(),
            rgb.shape[1] * rgb.shape[2], eps, _build.stream(rgb),
        )
        with _build.counter_lock:
            launches += 1
    _build.check(code, "color_deconv")
    return out
