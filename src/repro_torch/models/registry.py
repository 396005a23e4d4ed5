"""--arch <id> registry: the architectures this package runs.

Only the configs the port serves are listed; the JAX package's registry
(src/repro/models/registry.py) holds the rest, which arrive with the
slices that port their layers.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]

_MODULES = {
    "paper-gpt2-124m": "repro_torch.configs.paper_gpt2",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
}

ARCH_IDS: tuple[str, ...] = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).SMOKE
