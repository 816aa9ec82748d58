"""The port's LM stack: the decoder-only families (dense, moe, ssm, hybrid)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM, HybridLM

__all__ = ["LM", "HybridLM", "ModelConfig"]
