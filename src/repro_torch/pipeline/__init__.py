from repro_torch.pipeline.synth import make_slide, make_tile
from repro_torch.pipeline.wsi import (
    FeatureStage,
    SegmentationStage,
    analyze_tile,
    compute_features,
    extract_object_rois,
    make_wsi_storage,
    segment_mask,
    segment_tile,
)

__all__ = [
    "FeatureStage",
    "SegmentationStage",
    "analyze_tile",
    "compute_features",
    "extract_object_rois",
    "make_slide",
    "make_tile",
    "make_wsi_storage",
    "segment_mask",
    "segment_tile",
]
