"""Unified model configuration (a copy of ``repro.models.config``).

One dataclass describes every family the reference has, and the port runs
them all: the decoder-only ones (``models.transformer``) and ``encdec``
(``models.encdec``). Exact per-architecture
values live in ``repro_torch.configs``. Dtypes are ``torch.dtype``s, and
``attn_impl`` takes the port's kernel choices (``kernels.ops``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 512
    vocab: int = 1024
    head_dim: int | None = None  # defaults to d_model // num_heads

    # -- transformer details -------------------------------------------------
    mlp_kind: str = "swiglu"  # swiglu | geglu | relu2 | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    qk_norm: bool = False
    rope_theta: float = 10000.0
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    tie_embeddings: bool = False
    logit_softcap: float | None = None

    # -- attention pattern ------------------------------------------------------
    attn_kind: str = "gqa"  # gqa | mla
    window: int | None = None  # sliding-window size (SWA layers)
    num_global_layers: int = 0  # hybrid: how many full-attention layers

    # -- MLA (deepseek) ---------------------------------------------------------
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # -- MoE ----------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0  # d_ff of the dense (first_k) layers
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001
    moe_groups: int = 1

    # -- SSM (mamba2 SSD) -----------------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128  # SSD chunk length of the scan kernel

    # -- encoder-decoder ---------------------------------------------------------------
    enc_layers: int = 0
    cross_attention: bool = False

    # -- modality frontend stub (audio frames / ViT patches) ---------------------------
    frontend: str | None = None  # None | "audio" | "patch"
    frontend_len: int = 0  # prefix slots in the context

    # -- numerics & runtime ----------------------------------------------------------
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"  # auto | cuda | torch (kernels.ops)
    remat: str = "dots"  # none | dots | full (training; unused by serving)
    scan_layers: bool = True

    # -------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM or hybrid (SWA + few global layers)."""
        return self.family in ("ssm", "hybrid")

    def params_count(self) -> int:
        """Parameter count N, from the spec (allocates nothing)."""
        from repro_torch.models import registry

        return registry.count_params(self)

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def scaled_down(self, **overrides: Any) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw: dict[str, Any] = dict(
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128,
            vocab=256,
            window=min(self.window, 16) if self.window else None,
            num_global_layers=min(self.num_global_layers, 1),
            kv_lora_rank=32,
            qk_nope_dim=16,
            qk_rope_dim=8,
            v_head_dim=16,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.experts_per_token else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            first_k_dense=min(self.first_k_dense, 1),
            dense_d_ff=128 if self.dense_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            enc_layers=min(self.enc_layers, 2),
            frontend_len=min(self.frontend_len, 8) if self.frontend_len else 0,
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
            remat="none",
        )
        kw.update(overrides)
        return self.replace(**kw)
