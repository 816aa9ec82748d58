"""qwen3-0.6b [dense] — qk-norm + GQA [hf:Qwen/Qwen3-0.6B].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936; head_dim=128,
per-head RMS qk-norm, tied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab=151936,
    mlp_kind="swiglu",
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
)
