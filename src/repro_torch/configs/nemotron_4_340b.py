"""nemotron-4-340b [dense] — GQA + squared-ReLU MLP [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
Nemotron-4 uses squared ReLU and LayerNorm; rotary position embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab=256000,
    mlp_kind="relu2",
    norm_type="layernorm",
    rope_theta=10000.0,
)
