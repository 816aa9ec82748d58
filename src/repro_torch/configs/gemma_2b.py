"""gemma-2b [dense] — GeGLU, head_dim=256, MQA [arXiv:2403.08295].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000; embeddings scaled
by sqrt(d_model) and tied with the output projection.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    mlp_kind="geglu",
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
)
