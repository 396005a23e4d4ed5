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
    # Background-calibration accounting (core/calibrate.py): wall-clock
    # spent measuring/refitting on behalf of this selector, and how many
    # times a rebuilt table was atomically swapped in.  Off the serving
    # path entirely — the hot-path counters above never include these.
    calibration_seconds: float = 0.0
    table_swaps: int = 0

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
        # Calibration state (core/calibrate.py): a per-candidate cost
        # multiplier and measured-bucket winner pins.  Both None/empty by
        # default — the analytical sweep runs bit-identically — and only
        # replaced through install_table(), so doubling extensions rebuild
        # with the SAME refined model the installed table was built from.
        self._cost_scale: np.ndarray | None = None
        self._pinned: dict[int, int] = {}
        # Built lazily on first use: throwaway selectors (benchmarks,
        # analysis scripts) shouldn't pay the breakpoint sweep up front.
        self._table: SelectionTable | None = None

    @property
    def workload(self) -> Workload:
        return self._wl

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

    @property
    def stacked(self) -> StackedLattices:
        """The fused multi-backend candidate stack (what the background
        calibrator ranks, measures and refits over)."""
        return self._stacked

    # -- offline table ------------------------------------------------------

    def _build_table(self, m_max: int) -> SelectionTable:
        table = build_selection_table(
            self._hw, self._wl, self._stacked, m_max, self._num_cores,
            cost_scale=self._cost_scale, pinned=self._pinned or None,
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

    def _selection(self, idx: int, m_runtime: int, cost: float,
                   select_seconds: float) -> Selection:
        """The Selection candidate ``idx`` (stacked index) serves at
        ``m_runtime``: its launch grid, padded extent and bucket."""
        st = self._stacked
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
            predicted_cost=cost,
            select_seconds=select_seconds,
        )

    def _scaled_costs(self, m_runtime: int) -> np.ndarray:
        """(C,) costs at ``m_runtime`` under the installed calibration
        scale (the analytical ones when none is installed)."""
        st = self._stacked
        return runtime_costs(
            self._hw, self._wl, st.l1_tiles, st.l1_costs,
            m_runtime, self._num_cores, self._cost_scale,
        )

    def _select_argmin(self, m_runtime: int) -> Selection:
        """One fused numpy evaluation over ALL backends' candidates.

        Applies the installed calibration scale (if any) so the beyond-
        table fallback and doubling extensions stay consistent with the
        calibrated table contents; winner pins are table-only (they live
        inside the calibrated coverage by construction).
        """
        t0 = time.perf_counter()
        costs = self._scaled_costs(m_runtime)
        idx = int(np.argmin(costs))
        return self._selection(idx, m_runtime, float(costs[idx]),
                               time.perf_counter() - t0)

    def select_excluding(
        self, m_runtime: int, excluded, keyfn
    ) -> Selection | None:
        """Cheapest candidate at ``m_runtime`` whose ``keyfn(Selection)``
        is NOT in ``excluded`` — the degradation ladder's re-selection.
        Walks candidates in scaled-cost order off the hot path (one fused
        cost evaluation, Selections built only until the first healthy
        candidate); returns ``None`` when every candidate is excluded."""
        t0 = time.perf_counter()
        costs = self._scaled_costs(m_runtime)
        for idx in np.argsort(costs, kind="stable"):
            idx = int(idx)
            sel = self._selection(idx, m_runtime, float(costs[idx]),
                                  time.perf_counter() - t0)
            if keyfn(sel) not in excluded:
                return sel
        return None

    # -- calibration surface (core/calibrate.py) -----------------------------

    def candidate_selection(self, idx: int, m_runtime: int) -> Selection:
        """The Selection candidate ``idx`` (stacked index) would serve at
        extent ``m_runtime`` — what the calibrator builds executables for
        when timing non-winning candidates.  ``predicted_cost`` is the
        UNSCALED analytical cost; ``select_seconds`` is 0."""
        return self._selection(
            idx, m_runtime, float(self.candidate_costs(m_runtime)[idx]), 0.0
        )

    def candidate_costs(self, m_runtime: int) -> np.ndarray:
        """(C,) UNSCALED analytical costs at ``m_runtime`` — the paper's
        Eq. 2-4 ranking the calibrator takes its top-K from."""
        st = self._stacked
        return runtime_costs(
            self._hw, self._wl, st.l1_tiles, st.l1_costs,
            m_runtime, self._num_cores,
        )

    def rank_candidates(self, m_runtime: int, k: int) -> list[int]:
        """Indices of the ``k`` analytically-cheapest candidates at
        ``m_runtime``, cheapest first (the calibrator's measurement set)."""
        costs = self.candidate_costs(m_runtime)
        k = min(max(int(k), 1), costs.shape[0])
        top = np.argpartition(costs, k - 1)[:k]
        return [int(i) for i in top[np.argsort(costs[top])]]

    def build_calibrated_table(
        self,
        m_max: int | None = None,
        cost_scale: np.ndarray | None = None,
        pinned: Mapping[int, int] | None = None,
    ) -> SelectionTable:
        """Build (OFFLINE — nothing installed, serving untouched) a table
        from the refined model: per-candidate ``cost_scale`` multipliers
        plus measured-bucket winner ``pinned`` overrides."""
        table = self.table
        m_max = m_max if m_max is not None else (
            table.m_max if table is not None else self._table_m_max or 1
        )
        built = build_selection_table(
            self._hw, self._wl, self._stacked, m_max, self._num_cores,
            cost_scale=cost_scale,
            pinned=dict(pinned) if pinned else None,
        )
        self.stats.table_builds += 1
        self.stats.table_build_seconds += built.build_seconds
        return built

    def install_table(
        self,
        table: SelectionTable,
        *,
        cost_scale: np.ndarray | None = None,
        pinned: Mapping[int, int] | None = None,
        calibration_seconds: float = 0.0,
    ) -> None:
        """ATOMICALLY swap a fully-built table into the serving hot path.

        Install the refined model first (so the argmin fallback and any
        future doubling extension rebuild consistently), drop the LRU (its
        entries priced the old model), then publish the table with ONE
        attribute assignment: ``select`` reads ``self._table`` once per
        call and SelectionTable is frozen, so every concurrent select sees
        entirely the old table or entirely the new one.  The bisect lookup
        itself is untouched.
        """
        if not table.starts or table.starts[0] != 1:
            raise ValueError("selection table must cover extents from 1")
        self._cost_scale = (
            None if cost_scale is None
            else np.asarray(cost_scale, np.float64)
        )
        self._pinned = dict(pinned) if pinned else {}
        self._cache.clear()
        self._table = table  # the atomic publish
        self.stats.table_swaps += 1
        self.stats.calibration_seconds += calibration_seconds

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
