"""Hybrid analytical-empirical analyzer (paper §5.2).

Two observations drive the design (quoted from the paper): the bottom-up
construction means candidate counts *grow* with layer height, and
hard-to-model hardware behaviour (out-of-order issue, pipelining)
concentrates at the *lowest* layers.  So:

  * layer 0 (and optionally layer 1) strategies are scored **empirically**
    via a pluggable :class:`Profiler`,
  * all higher layers — and everything at runtime — use the **analytical**
    model (cost_model.py), keeping runtime selection overhead negligible.

The wall-clock profiler measures real matmul timings on a device (CUDA
events on the card, the host clock on the CPU); for the accelerator
targets a calibrated-table profiler stands in by default, as in the JAX
package, and the analyzer structure is unchanged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.candidates import CandidateLattice, Tile
from repro_torch.core.cost_model import l0_analytical_cost, strategy_cost
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.rkernel import Strategy
from repro_torch.core.workloads import Workload
from repro_torch.device import resolve_device

__all__ = [
    "Profiler",
    "AnalyticalProfiler",
    "WallClockProfiler",
    "TableProfiler",
    "ScoredLattice",
    "StackedLattices",
    "HybridAnalyzer",
]


class Profiler:
    """Interface: measure the cost (seconds) of one layer-0 tile contraction."""

    name = "abstract"

    def measure_l0(self, tile: Tile, backend: str) -> float:
        raise NotImplementedError

    def measure_l1(self, tile: Tile, backend: str) -> float | None:
        """Optionally measure a whole layer-1 tile; ``None`` -> analytical."""
        return None


class AnalyticalProfiler(Profiler):
    """Pure-analytical stand-in (used when a layer is configured analytical)."""

    name = "analytical"

    def __init__(self, hw: HardwareSpec):
        self._hw = hw

    def measure_l0(self, tile: Tile, backend: str) -> float:
        return l0_analytical_cost(self._hw, tile, backend)


class TableProfiler(Profiler):
    """Calibrated-efficiency table for detached hardware (TPU in this box).

    Efficiency factors model the MXU pipeline: tiles below the native shape
    waste systolic slots; very deep k amortizes issue overhead.  The factors
    are calibration inputs, not measurements — they play the role the
    empirical leg plays on attached hardware and are swappable for real
    ``pallas_call`` timings on a pod.
    """

    name = "table"

    def __init__(self, hw: HardwareSpec):
        self._hw = hw

    def measure_l0(self, tile: Tile, backend: str) -> float:
        base = l0_analytical_cost(self._hw, tile, backend)
        bm, bn, bk = self._hw.native_tile[backend]
        m, n, k = tile
        # Occupancy of the systolic array within the padded issue.
        occ = min(m / max(bm, 1), 8.0) / max(1.0, np.ceil(m / bm))
        depth_bonus = 1.0 / (1.0 + 0.25 * (128.0 / max(k, 1)))
        eff = max(0.05, min(1.0, 0.6 + 0.05 * occ) * depth_bonus)
        return base / eff


class WallClockProfiler(Profiler):
    """Real wall-clock measurement of tile contractions on one device: the
    card by default (raises without a GPU; pass ``device="cpu"``).

    On a CUDA device each timing is the minimum over ``repeats`` launches
    bracketed by CUDA events (PyTorch returns before the card finishes, so
    a host clock would time the enqueue); on the CPU it is the minimum of
    ``perf_counter`` intervals.  Timings are cached so
    the offline stage stays in the seconds regime the paper reports.
    """

    name = "wallclock"

    def __init__(self, device="cuda", repeats: int = 5):
        # The card unless asked: raises without a GPU unless device="cpu".
        self._device = resolve_device(device)
        self._repeats = repeats
        self._cache: dict[str, float] = {}

    def _key(self, tile: Tile, backend: str, level: int) -> str:
        return f"L{level}:{backend}:{tile[0]}x{tile[1]}x{tile[2]}"

    def _time_matmul(self, m: int, n: int, k: int) -> float:
        a = torch.zeros((m, k), dtype=torch.float32, device=self._device)
        b = torch.zeros((k, n), dtype=torch.float32, device=self._device)
        torch.matmul(a, b)  # warm
        best = float("inf")
        if self._device.type == "cuda":
            for _ in range(self._repeats):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                torch.matmul(a, b)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) * 1e-3)
            return best
        for _ in range(self._repeats):
            t0 = time.perf_counter()
            torch.matmul(a, b)
            best = min(best, time.perf_counter() - t0)
        return best

    def _measure(self, tile: Tile, backend: str, level: int) -> float:
        key = self._key(tile, backend, level)
        if key not in self._cache:
            m, n, k = tile
            self._cache[key] = self._time_matmul(m, n, k)
        return self._cache[key]

    def measure_l0(self, tile: Tile, backend: str) -> float:
        return self._measure(tile, backend, 0)

    def measure_l1(self, tile: Tile, backend: str) -> float:
        return self._measure(tile, backend, 1)


@dataclasses.dataclass(frozen=True)
class ScoredLattice:
    """Analyzer output: layer-1 candidates with per-tile costs, ready for the
    vectorized runtime selector (numpy arrays, no Python loops at runtime).
    """

    backend: str
    l1_tiles: np.ndarray  # (C, 3) int64
    l1_costs: np.ndarray  # (C,) seconds per layer-1 tile
    best_l0: tuple[Tile, ...]  # chosen layer-0 child per layer-1 tile
    analyze_seconds: float
    num_measured: int

    def strategy_for(self, idx: int) -> Strategy:
        l1 = tuple(int(x) for x in self.l1_tiles[idx])
        return Strategy(tiles=(self.best_l0[idx], l1), backend=self.backend)


@dataclasses.dataclass(frozen=True)
class StackedLattices:
    """All backends' scored lattices fused into flat candidate arrays.

    The runtime selector and the offline selection-table builder both want
    ONE numpy cost evaluation over the whole multi-backend strategy space
    (the per-tile costs already encode each backend's level-0/1 behaviour),
    so the per-backend ScoredLattices are concatenated once here and indexed
    by a single global candidate id.  Backend order follows the mapping
    order, so argmin tie-breaking is deterministic.
    """

    backends: tuple[str, ...]
    scored: tuple[ScoredLattice, ...]
    l1_tiles: np.ndarray  # (C, 3) int64, backends concatenated in order
    l1_costs: np.ndarray  # (C,) seconds per layer-1 tile
    backend_idx: np.ndarray  # (C,) int64: candidate -> backends index
    offsets: tuple[int, ...]  # per-backend start offset into the flat arrays

    @classmethod
    def stack(cls, scored: Mapping[str, ScoredLattice]) -> "StackedLattices":
        if not scored:
            raise ValueError("need at least one scored lattice")
        backends = tuple(scored)
        sls = tuple(scored[b] for b in backends)
        offsets, acc = [], 0
        for sl in sls:
            offsets.append(acc)
            acc += sl.l1_costs.shape[0]
        return cls(
            backends=backends,
            scored=sls,
            l1_tiles=np.concatenate([sl.l1_tiles for sl in sls], axis=0),
            l1_costs=np.concatenate([sl.l1_costs for sl in sls], axis=0),
            backend_idx=np.concatenate(
                [
                    np.full(sl.l1_costs.shape[0], i, np.int64)
                    for i, sl in enumerate(sls)
                ]
            ),
            offsets=tuple(offsets),
        )

    @property
    def num_candidates(self) -> int:
        return int(self.l1_costs.shape[0])

    def backend_of(self, idx: int) -> str:
        return self.backends[int(self.backend_idx[idx])]

    def strategy_for(self, idx: int) -> Strategy:
        b = int(self.backend_idx[idx])
        return self.scored[b].strategy_for(int(idx) - self.offsets[b])

    def dynamic_periods(self, axes: Sequence[int]) -> tuple[int, ...]:
        """Distinct l1 extents along the dynamic tile axes, across ALL
        backends — the periods at which any candidate's grid cost ticks."""
        return tuple(
            sorted({int(t) for ax in axes for t in self.l1_tiles[:, ax]})
        )


class HybridAnalyzer:
    """Score a candidate lattice with the hybrid empirical/analytical split.

    ``empirical_levels`` mirrors the paper's per-platform defaults (Table 7):
    ``(0,)`` for CPU, ``(0, 1)`` for GPU/TPU-style targets.
    """

    def __init__(
        self,
        hw: HardwareSpec,
        wl: Workload,
        profiler: Profiler | None = None,
        empirical_levels: Sequence[int] = (0,),
    ):
        self._hw = hw
        self._wl = wl
        self._profiler = profiler or AnalyticalProfiler(hw)
        self._empirical_levels = tuple(empirical_levels)

    def _l0_cost(self, tile: Tile, backend: str) -> float:
        if 0 in self._empirical_levels:
            return self._profiler.measure_l0(tile, backend)
        return l0_analytical_cost(self._hw, tile, backend)

    def score(self, lattice: CandidateLattice) -> ScoredLattice:
        """For every layer-1 candidate, pick its cheapest layer-0 child and
        record the layer-1 per-tile cost (Eq. 2 composition, or an empirical
        layer-1 measurement when level 1 is configured empirical)."""
        t0 = time.perf_counter()
        backend = lattice.backend
        l0_cost_cache: dict[Tile, float] = {}
        measured = 0

        tiles: list[Tile] = []
        costs: list[float] = []
        best_children: list[Tile] = []
        for l1 in lattice.l1:
            children = lattice.children[1][l1]
            best_c, best_child = float("inf"), children[0]
            for child in children:
                if child not in l0_cost_cache:
                    l0_cost_cache[child] = self._l0_cost(child, backend)
                    measured += 1
                strat = Strategy(tiles=(child, l1), backend=backend)
                # Cost of ONE layer-1 tile: evaluate the recursion at a shape
                # equal to the tile itself (grid = 1x1x1).
                bd = strategy_cost(
                    self._hw,
                    self._wl,
                    strat,
                    cost_l0=l0_cost_cache[child],
                    dims=(int(l1[0]), int(l1[1]), int(l1[2])),
                )
                if bd.l1_per_tile < best_c:
                    best_c, best_child = bd.l1_per_tile, child
            if 1 in self._empirical_levels:
                emp = self._profiler.measure_l1(l1, backend)
                if emp is not None:
                    best_c = emp
                    measured += 1
            tiles.append(l1)
            costs.append(best_c)
            best_children.append(best_child)

        return ScoredLattice(
            backend=backend,
            l1_tiles=np.asarray(tiles, np.int64),
            l1_costs=np.asarray(costs, np.float64),
            best_l0=tuple(best_children),
            analyze_seconds=time.perf_counter() - t0,
            num_measured=measured,
        )
