from repro_torch.pipeline.synth import make_slide, make_tile
from repro_torch.pipeline.wsi import (
    analyze_tile,
    compute_features,
    extract_object_rois,
    segment_mask,
    segment_tile,
)

__all__ = [
    "analyze_tile",
    "compute_features",
    "extract_object_rois",
    "make_slide",
    "make_tile",
    "segment_mask",
    "segment_tile",
]
