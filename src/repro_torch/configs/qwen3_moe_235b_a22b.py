"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8 [hf:Qwen/Qwen3-235B-A22B].

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936; qk-norm;
no shared experts; every layer MoE.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    mlp_kind="swiglu",
    qk_norm=True,
    num_experts=128,
    experts_per_token=8,
    capacity_factor=1.25,
    rope_theta=1000000.0,
)
