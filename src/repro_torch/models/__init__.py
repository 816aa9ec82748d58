"""The port's LM stack: the hybrid (Hymba) family so far."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import HybridLM

__all__ = ["HybridLM", "ModelConfig"]
