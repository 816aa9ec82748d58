"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone
[arXiv:2308.11596].

24L enc + 24L dec, d_model=1024 16H (MHA kv=16) d_ff=8192 vocab=256206.
The audio frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (B, S_enc, d_model) per the assignment brief.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    enc_layers=24,
    cross_attention=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    mlp_kind="gelu",
    frontend="audio",
    rope_theta=10000.0,
)
