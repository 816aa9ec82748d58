"""The port's LM stack: the decoder-only families (dense, moe, ssm, hybrid)
and the encoder-decoder one; ``build`` makes either."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.registry import build
from repro_torch.models.transformer import LM, HybridLM

__all__ = ["EncDec", "LM", "HybridLM", "ModelConfig", "build"]
