"""granite-20b [dense] — Granite Code 20B [arXiv:2405.04324].

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
The HF granite-20b-code is gpt_bigcode-style: gelu MLP (2 matrices) +
LayerNorm — that is what lands the model at ~20B parameters (a swiglu MLP
would give 28B).  We keep RoPE for positions (the spec bracket says
"llama-arch"); the MLP/norm follow the released 20B checkpoint.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    mlp_kind="gelu",
    norm_type="layernorm",
    rope_theta=10000.0,
)
