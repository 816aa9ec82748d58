"""internvl2-1b [vlm] — InternViT + Qwen2-0.5B backbone [arXiv:2404.16821].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
The ViT frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings (B, 256, d_model) prefixed to the token context.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151655,
    mlp_kind="swiglu",
    frontend="patch",
    frontend_len=256,
    rope_theta=1000000.0,
)
