"""Runtime strategy selection and kernel construction (paper §6.2).

At runtime the shape becomes known.  The selector returns the winning
strategy plus launch geometry — the candidate evaluation uses the
*analytical* grid-level model (including padding waste) over the pre-scored
lattices of every compute backend (tensor core vs CUDA core on the H100, as
in the paper's Fig. 16; MXU vs VPU on the TPU).

The serving hot path is CONSTANT TIME: because the cost of every candidate
is piecewise constant in M between lattice breakpoints, the whole decision
for all M <= table.m_max is materialized offline into a sorted
breakpoint table (selection_table.py) and served by a bisect — O(log B),
zero numpy, zero allocation, covering unseen shapes as cheaply as repeated
ones.  Beyond the table, selection falls back to a fused multi-backend
numpy argmin (all backends' candidates stacked into one evaluation — no
per-backend Python loop) and the table extends itself by doubling, so a
growing stream pays O(log m) rebuilds, amortized to nothing.

A small LRU remains for extents past the extension limit; ``SelectorStats``
accounts table hits, LRU hits and argmin misses separately so the Fig. 14
overhead numbers stay meaningful.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Mapping

import numpy as np

from repro_torch.core.analyzer import ScoredLattice, StackedLattices
from repro_torch.core.cost_model import runtime_costs
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.rkernel import Strategy
from repro_torch.core.selection_table import SelectionTable, build_selection_table
from repro_torch.core.workloads import Workload

__all__ = ["Selection", "RuntimeSelector", "SelectorStats"]


@dataclasses.dataclass(frozen=True)
class Selection:
    """A constructed kernel for one runtime shape.

    ``bucket`` is the executable-cache key shape: padding is confined to the
    dynamic dims and only up to the lattice tile, while static dims keep
    their TRUE extents (they are never padded at the bucket level) — the
    sample-free bucketing induced by the candidate lattice (DESIGN.md §4).

    ``select_seconds`` is the argmin-path scheduling overhead that produced
    this object; table-materialized selections carry 0.0 (their cost was
    paid once offline — per-serve accounting lives in SelectorStats).
    """

    strategy: Strategy
    backend: str
    grid: tuple[int, int, int]            # (gm, gn, gk) launch geometry
    padded_m: int                          # dynamic dim rounded to l1 m-tile
    bucket: tuple[int, int, int]           # executable-cache key shape
    predicted_cost: float                  # seconds (analytical)
    select_seconds: float                  # argmin overhead (0.0 from table)


@dataclasses.dataclass
class SelectorStats:
    """Runtime-overhead accounting for the serving path (Fig. 14).

    Every serve is exactly one of: a table hit (bisect, constant time), an
    LRU hit (dict lookup), or an argmin miss (fused numpy evaluation).
    ``select_seconds`` accumulates ONLY argmin time, so ``mean_select_us``
    is the true per-miss cost — a cached selection no longer re-reports the
    stale latency of its original miss.
    """

    selects: int = 0
    table_hits: int = 0
    lru_hits: int = 0
    argmin_misses: int = 0
    select_seconds: float = 0.0          # argmin-path time only
    table_builds: int = 0
    table_build_seconds: float = 0.0

    @property
    def cache_hits(self) -> int:
        """Serves that skipped the argmin entirely (table + LRU)."""
        return self.table_hits + self.lru_hits

    @property
    def mean_select_us(self) -> float:
        return (
            self.select_seconds / self.argmin_misses * 1e6
            if self.argmin_misses else 0.0
        )


class RuntimeSelector:
    """Select strategies for runtime shapes from pre-scored lattices.

    ``scored`` maps backend name -> ScoredLattice; the lattices are stacked
    into one fused candidate array at construction.  ``num_cores`` is the
    number of level-2 units the kernel may occupy (SMs on the H100).

    ``table_m_max`` sizes the offline-materialized selection table (0
    disables it: pure argmin + LRU, used by equivalence tests and as the
    behaviour past ``table_extend_limit``).  ``cache_size`` bounds the LRU
    that backs extents the table does not cover.
    """

    def __init__(
        self,
        hw: HardwareSpec,
        wl: Workload,
        scored: Mapping[str, ScoredLattice],
        num_cores: int = 1,
        cache_size: int = 4096,
        table_m_max: int = 4096,
        table_extend_limit: int = 1 << 17,
    ):
        if not scored:
            raise ValueError("need at least one scored lattice")
        self._hw = hw
        self._wl = wl
        self._scored = dict(scored)
        self._stacked = StackedLattices.stack(self._scored)
        self._num_cores = num_cores
        self._cache: collections.OrderedDict[int, Selection] = (
            collections.OrderedDict()
        )
        self._cache_size = cache_size
        self._table_m_max = table_m_max
        self._table_extend_limit = table_extend_limit
        self.stats = SelectorStats()
        # Built lazily on first use: throwaway selectors (benchmarks,
        # analysis scripts) shouldn't pay the breakpoint sweep up front.
        self._table: SelectionTable | None = None

    @property
    def scored(self) -> dict[str, ScoredLattice]:
        """The per-backend scored lattices this selector serves from."""
        return dict(self._scored)

    @property
    def table(self) -> SelectionTable | None:
        """The materialized selection table (built on first access; None
        when disabled via ``table_m_max=0``)."""
        if self._table is None and self._table_m_max > 0:
            self._table = self._build_table(self._table_m_max)
        return self._table

    @property
    def table_if_built(self) -> SelectionTable | None:
        """The installed table WITHOUT triggering the lazy build — what
        introspection (engine stats) should read, so reporting never
        charges a sweep to an idle selector."""
        return self._table

    # -- offline table ------------------------------------------------------

    def _build_table(self, m_max: int) -> SelectionTable:
        table = build_selection_table(
            self._hw, self._wl, self._stacked, m_max, self._num_cores,
        )
        self.stats.table_builds += 1
        self.stats.table_build_seconds += table.build_seconds
        return table

    def _table_covering(self, m_max: int) -> SelectionTable:
        """A table covering [1, m_max], extending the installed one by
        doubling when enabled; transient when the table is disabled."""
        table = self.table  # materializes the initial table when enabled
        if table is None:
            return self._build_table(m_max)
        if table.m_max >= m_max:
            return table
        new_max = table.m_max
        while new_max < m_max:
            new_max *= 2
        self._table = self._build_table(new_max)
        return self._table

    # -- runtime selection ---------------------------------------------------

    def select(self, m_runtime: int) -> Selection:
        """Pick the (backend, strategy) minimizing predicted cost at M.

        Hot path: bisect into the materialized table.  Fallbacks: LRU, then
        the fused argmin (which also triggers a doubling table extension so
        the NEXT unseen extent of this magnitude is a table hit).
        """
        stats = self.stats
        stats.selects += 1
        table = self.table  # materializes on the first select
        # covers() also rejects m < 1: degenerate (empty) extents take the
        # argmin path, which prices them exactly (grid 0, zero cost).
        if table is not None and table.covers(m_runtime):
            stats.table_hits += 1
            return table.lookup(m_runtime)
        cached = self._cache.get(m_runtime)
        if cached is not None:
            self._cache.move_to_end(m_runtime)
            stats.lru_hits += 1
            return cached
        sel = self._select_argmin(m_runtime)
        stats.argmin_misses += 1
        stats.select_seconds += sel.select_seconds
        self._cache[m_runtime] = sel
        if len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        if (
            table is not None
            and table.m_max < m_runtime <= self._table_extend_limit
        ):
            self._table_covering(m_runtime)
        return sel

    def _select_argmin(self, m_runtime: int) -> Selection:
        """One fused numpy evaluation over ALL backends' candidates."""
        t0 = time.perf_counter()
        st = self._stacked
        costs = runtime_costs(
            self._hw, self._wl, st.l1_tiles, st.l1_costs,
            m_runtime, self._num_cores,
        )
        idx = int(np.argmin(costs))
        strategy = st.strategy_for(idx)
        m1, n1, k1 = strategy.l1
        M, N, K = self._wl.runtime_dims(m_runtime)
        grid = (
            math.ceil(M / m1),
            math.ceil(N / n1),
            math.ceil(K / k1),
        )
        return Selection(
            strategy=strategy,
            backend=st.backend_of(idx),
            grid=grid,
            padded_m=grid[0] * m1,
            bucket=self._wl.bucket_dims(grid, strategy.l1),
            predicted_cost=float(costs[idx]),
            select_seconds=time.perf_counter() - t0,
        )

    # -- sample-free precompilation set --------------------------------------

    def selections_upto(self, m_max: int) -> list[Selection]:
        """One representative Selection per distinct outcome reachable for M
        in [1, m_max] — the finite, sample-free precompilation set.

        Shared machinery with the serving table: the breakpoint sweep
        already materializes one Selection per cost-constant interval
        (divisor-free heap merge of the dynamic periods — no O(m_max)
        range-set enumeration), so this is a dedupe over the table entries
        by executable-relevant identity (bucket + strategy + backend).
        """
        table = self._table_covering(m_max)
        seen: set[tuple] = set()
        out: list[Selection] = []
        for start, sel in zip(table.starts, table.entries):
            if start > m_max:
                break
            key = (sel.bucket, sel.strategy.tiles, sel.backend)
            if key not in seen:
                seen.add(key)
                out.append(sel)
        return out

    def buckets_upto(self, m_max: int) -> list[int]:
        """All distinct padded dynamic-extent buckets the selector can emit
        for M in [1, m_max] (``Workload.dynamic_bucket``: padded_m for
        GEMM-view workloads, the kv bucket for decode attention)."""
        return sorted({
            self._wl.dynamic_bucket(s) for s in self.selections_upto(m_max)
        })
