"""The port's kernels, for the WSI main path (color deconvolution,
reconstruction, connected components, GLCM) and the LM path (flash
attention, SSD scan): plain PyTorch versions (``ref``), the hand-written
CUDA kernels (one wrapper module each), and ``ops``, which dispatches
between them on the tensor's device.

Importing this package builds nothing; the CUDA library is compiled on the
first launch (``_build``).
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
