"""--arch <id> registry: maps architecture ids to configs and shape skips
(counterpart of src/repro/models/registry.py).

Every architecture of the JAX package is registered.  ``ARCH_IDS`` lists
them all, ``paper-gpt2-124m`` included; the dry run's cells
(:func:`all_cells`) span the ten assigned ones (``ASSIGNED_ARCH_IDS``, the
reference's ``ARCH_IDS``).  ``cell_supported(arch, shape)`` encodes the
skip rule: ``long_500k`` needs sub-quadratic attention (SSM / hybrid /
SWA).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig

__all__ = ["ARCH_IDS", "ASSIGNED_ARCH_IDS", "get_config", "get_smoke_config",
           "cell_supported", "all_cells"]

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

# The reference's ARCH_IDS: the assigned architectures, in its order
# (src/repro/models/registry.py:22-38), without the paper's own gpt2.
ASSIGNED_ARCH_IDS: tuple[str, ...] = (
    "gemma2-9b", "phi4-mini-3.8b", "h2o-danube-3-4b", "starcoder2-15b",
    "deepseek-v2-236b", "granite-moe-1b-a400m", "internvl2-26b",
    "whisper-small", "jamba-v0.1-52b", "falcon-mamba-7b",
)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).SMOKE


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    """(supported, reason-if-not) for one (arch x shape) cell."""
    cfg = get_config(arch)
    spec = SHAPES[shape]
    if spec.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{arch} is full-attention (see DESIGN.md §4)"
        )
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    """The 40 assigned (arch, shape) cells, including skipped ones."""
    return [(a, s) for a in ASSIGNED_ARCH_IDS for s in SHAPES]
