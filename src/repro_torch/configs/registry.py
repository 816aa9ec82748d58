"""Architecture registry: ``--arch <id>`` -> ModelConfig, for the ten
architectures of the reference (``repro.configs.registry``), every one of
them ported: nine decoder-only and the encoder-decoder
``seamless-m4t-large-v2``."""
from __future__ import annotations

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


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).CONFIG
