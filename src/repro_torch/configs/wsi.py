"""The paper's own workload: whole-slide-image analysis pipeline config.

Matches the experimental setup of S5: 4K x 4K tiles, segmentation +
feature-computation stages, per-operation GPU speedups from Fig. 16.

A copy of ``repro.configs.wsi``: the port loads no module of the JAX
package, so it keeps its own.
"""
from __future__ import annotations

import dataclasses



@dataclasses.dataclass(frozen=True)
class WSIConfig:
    tile: int = 4096  # 4K x 4K tiles (paper S5)
    channels: int = 3
    num_bins: int = 32  # GLCM / histogram quantization
    nucleus_roi: int = 64  # padded per-object ROI (feature stage)
    max_objects_per_tile: int = 512
    seg_threshold: float = 0.55
    partition: int = 1024  # worker partition edge (smoke/demo scale)


# Per-operation GPU speedups following the paper's Fig. 16 profile — the
# inputs PATS runs on (strong variability is the point).
PAPER_OP_SPEEDUPS: dict[str, float] = {
    "RBC detection": 1.9,
    "Morph. Open": 3.5,
    "ReconToNuclei": 13.0,
    "AreaThreshold": 1.5,
    "FillHolles": 7.0,
    "Pre-Watershed": 15.0,
    "Watershed": 7.0,
    "BWLabel": 2.0,
    "Features": 17.0,
    "Color deconv.": 6.0,
    "Canny": 4.0,
    "Gradient": 8.0,
}

# Relative CPU cost of each operation within a stage.  The paper does not
# publish the per-op cost mix; this profile weights the heavy operators
# (reconstruction, watershed, features) the way S5.1 describes, and the
# scheduler-benchmark ratios depend on it (trends do not).
PAPER_OP_COSTS: dict[str, float] = {
    "RBC detection": 0.4,
    "Morph. Open": 0.6,
    "ReconToNuclei": 3.2,
    "AreaThreshold": 0.2,
    "FillHolles": 1.2,
    "Pre-Watershed": 2.2,
    "Watershed": 2.0,
    "BWLabel": 0.5,
    "Features": 4.5,
    "Color deconv.": 0.5,
    "Canny": 0.6,
    "Gradient": 0.5,
}

CONFIG = WSIConfig()
