"""PyTorch/CUDA port of the Region Templates reproduction.

The JAX package ``repro`` is the reference; this package imports nothing of
it and nothing of JAX. So far it holds two paths over six hand-written CUDA
kernels for Hopper (``kernels``):

* the WSI main path on color deconvolution, reconstruction, connected
  components and GLCM, in its three forms: plain functions
  (``pipeline.analyze_tile``), region-template stages under the runtime
  (``pipeline.SegmentationStage``/``FeatureStage`` over ``storage`` and
  ``runtime``), and near-data kernel chains (``kernels.chains``) that the
  serving gateway (``serve.RegionGateway.compute``) runs next to the data,
  with its DMS on socket or shared-memory server processes
  (``storage.spawn_servers``);
* LM serving for the hybrid family (``hymba-1.5b``: ``models``,
  ``serve.generate``, ``launch.serve``), whose prefill runs on flash
  attention and the Mamba2 SSD scan.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see ``device.resolve_device``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
