"""Dry-run analysis: the per-rank cost counter and the roofline terms
(``repro.analysis``)."""
from repro_torch.analysis import cost, roofline

__all__ = ["cost", "roofline"]
