"""Architecture registry: ``--arch <id>`` -> ModelConfig, for the ten
architectures of the reference (``repro.configs.registry``), every one of
them ported: nine decoder-only and the encoder-decoder
``seamless-m4t-large-v2``; plus the assigned input-shape table (40 cells)
and its applicability rules."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
}

ARCH_IDS = list(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell; else the documented skip."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, "long_500k needs sub-quadratic attention (skip: full-attention arch)"
    return True, ""


def all_cells() -> list[tuple[str, str, bool, str]]:
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = cell_supported(cfg, shape)
            out.append((arch, shape, ok, why))
    return out
