"""The port's LM stack: the decoder-only families (dense, moe, ssm, hybrid)
and the encoder-decoder one; ``build`` makes either, ``shard_params`` lays
its parameters out on a device mesh."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.registry import build
from repro_torch.models.transformer import LM, HybridLM, shard_params

__all__ = ["EncDec", "LM", "HybridLM", "ModelConfig", "build", "shard_params"]
