"""PyTorch/CUDA port of the Region Templates reproduction.

The JAX package ``repro`` is the reference; this package imports nothing of
it and nothing of JAX. So far it holds the WSI main path in plain-function
form (``pipeline.analyze_tile``) over four hand-written CUDA kernels for
Hopper (``kernels``). Entry points run on the CUDA card unless the caller
passes ``device="cpu"`` (see ``device.resolve_device``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
