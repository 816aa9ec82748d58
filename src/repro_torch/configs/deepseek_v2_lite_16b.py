"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + fine-grained MoE
[arXiv:2405.04434].

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400; MoE 64 routed experts
top-6 + 2 shared; first layer dense (d_ff 10944); MLA compressed KV cache
(kv_lora_rank=512, decoupled RoPE dim 64).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    mlp_kind="swiglu",
    attn_kind="mla",
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    first_k_dense=1,
    dense_d_ff=10944,
    capacity_factor=1.25,
    rope_theta=10000.0,
)
