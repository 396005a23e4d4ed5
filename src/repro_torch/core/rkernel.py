"""rKernel: the unified recursive abstraction (paper §4, Algorithm 1, Fig. 10).

A tensor program is decomposed into hierarchical layers.  Each layer owns
three loop sets — Parallel (PL), Temporal-Spatial (TSL) and
Temporal-Reduction (TRL) — and three stages: ``Load``, the recursive
``rKernel(L-1)``, and ``Store``.  The layer metadata mirrors the paper's
``layer_meta_info`` struct verbatim (Fig. 10): depth, per-axis loop types,
the analyzer kind used at that layer, and the load/store/compute hooks.

This module holds the declarative metadata (:class:`LayerMetaInfo`,
:class:`RKernelProgram`) consumed by the candidate generator, analyzer and
kernel builders, and the :class:`Strategy` a selection resolves to.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Mapping

__all__ = [
    "LoopType",
    "AnalyzeType",
    "LayerMetaInfo",
    "RKernelProgram",
    "Strategy",
]


class LoopType(enum.Enum):
    """Loop classification at one layer (Algorithm 1)."""

    PARALLEL = "PL"
    TEMPORAL_SPATIAL = "TSL"
    TEMPORAL_REDUCTION = "TRL"


class AnalyzeType(enum.Enum):
    """Which analyzer evaluates strategies at a layer (paper Fig. 10)."""

    EMPIRICAL = "empirical"
    ANALYTICAL = "analytical"


@dataclasses.dataclass(frozen=True)
class LayerMetaInfo:
    """Metadata for one rKernel layer (paper Fig. 10 ``layer_meta_info``).

    ``load_func``/``store_func``/``compute_func`` are *names* resolved by the
    code generator (kernels/) rather than function pointers: the same program
    description must drive both the CUDA kernels and the plain PyTorch
    lowering.
    """

    layer_depth: int
    loop_type: Mapping[str, LoopType]
    analyzer: AnalyzeType
    load_func: str
    store_func: str
    compute_func: str


@dataclasses.dataclass(frozen=True)
class Strategy:
    """A fully-specified hierarchical strategy: one tile per rKernel layer.

    ``tiles[d]`` is the (m, n, k) tile computed by ONE instance at depth d.
    Invariant (paper §5.1, Fig. 8): every dim of ``tiles[d+1]`` is an integer
    multiple of the corresponding dim of ``tiles[d]``.
    ``backend`` selects the level-0 compute unit (tensor_core vs cuda_core on the H100, mxu vs vpu on the TPU; §6.2).
    """

    tiles: tuple[tuple[int, int, int], ...]
    backend: str = "mxu"

    def __post_init__(self) -> None:
        for lo, hi in zip(self.tiles, self.tiles[1:]):
            for a, b in zip(lo, hi):
                if b % a:
                    raise ValueError(
                        f"strategy violates the multiples invariant: {hi} is "
                        f"not an elementwise multiple of {lo}"
                    )

    @property
    def l0(self) -> tuple[int, int, int]:
        return self.tiles[0]

    @property
    def l1(self) -> tuple[int, int, int]:
        return self.tiles[-1]


@dataclasses.dataclass(frozen=True)
class RKernelProgram:
    """A tensor program decomposed per Algorithm 1: one LayerMetaInfo per
    hardware level, innermost first."""

    kind: str
    layers: tuple[LayerMetaInfo, ...]
    hardware: str

    @property
    def depth(self) -> int:
        return len(self.layers)
