"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060].

64L d_model=2560 vocab=50280, ssm_state=128, headdim=64, expand=2
(d_inner=5120, 80 SSD heads), depthwise conv k=4.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=80,  # SSD heads (d_inner / headdim)
    num_kv_heads=80,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_expand=2,
)
