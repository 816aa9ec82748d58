"""Architecture registry: ``--arch <id>`` -> ModelConfig, for the
architectures the port runs. The reference knows ten
(``repro.configs.registry``); the others are named here and raise until
their family is ported."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
}

# The reference's other architectures, not yet ported.
NOT_PORTED = (
    "nemotron-4-340b",
    "gemma-2b",
    "qwen3-0.6b",
    "granite-20b",
    "seamless-m4t-large-v2",
    "internvl2-1b",
    "qwen3-moe-235b-a22b",
    "deepseek-v2-lite-16b",
    "mamba2-2.7b",
)

ARCH_IDS = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not yet ported to repro_torch; ported: {ARCH_IDS}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).CONFIG
