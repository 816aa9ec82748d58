"""Data pipelines: synthetic token streams + RT-backed loaders
(``repro.data``)."""
from repro_torch.data.loader import RegionTemplateLoader
from repro_torch.data.tokens import SyntheticTokens

__all__ = ["RegionTemplateLoader", "SyntheticTokens"]
