"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer
(a copy of ``repro.configs.hymba_1_5b``).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
SWA window 1024 with 3 full-attention layers (first/middle/last), per the
Hymba recipe [arXiv:2411.13676]. The global layers sit between the SWA
segments (``models.transformer._segments``).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    mlp_kind="swiglu",
    window=1024,
    num_global_layers=3,
    ssm_state=16,
    ssm_headdim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_expand=2,
    rope_theta=10000.0,
)
