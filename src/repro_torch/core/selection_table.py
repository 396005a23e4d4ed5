"""Offline-materialized selection tables: constant-time dynamic dispatch.

The vectorized runtime cost of every candidate (cost_model.runtime_costs)
is *piecewise constant* in the dynamic extent M: it changes only where some
``ceil(M / t)`` ticks over, i.e. at M = j*t + 1 for a dynamic tile extent
``t`` present in the lattice.  ``selections_upto`` has always exploited
that property to enumerate the finite precompilation set; this module takes
the same observation to its runtime conclusion — the ENTIRE selection
decision for all M <= m_max can be materialized offline:

  1. merge the breakpoint streams of every distinct dynamic period
     (heap-merge of arithmetic progressions — divisor-free: nothing ever
     enumerates the integers 1..m_max),
  2. evaluate ONE fused numpy cost matrix over (all backends' candidates x
     all breakpoint intervals) — ``runtime_cost_matrix`` — and take the
     argmin per interval,
  3. merge consecutive intervals whose winner AND launch grid coincide, and
     store a sorted ``starts -> Selection`` array.

Runtime selection is then ``entries[bisect_right(starts, m) - 1]``:
O(log B) comparisons on a Python list — zero numpy, zero allocation, zero
hashing — for EVERY M <= m_max, seen before or not.  This is what keeps
dispatch in the sub-microsecond regime under high-cardinality shape streams
(every sequence length distinct), where an LRU keyed by raw M thrashes.

Beyond ``m_max`` the selector falls back to the fused argmin and the table
extends itself by doubling (selector.py), so the table is an accelerator,
never a correctness boundary: table lookups and the argmin path agree
exactly (bit-identical float arithmetic; tests/test_torch_core.py holds the
port's tables against the reference's).
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import TYPE_CHECKING, Sequence

import numpy as np

from repro_torch.core.analyzer import StackedLattices
from repro_torch.core.cost_model import runtime_cost_matrix
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.workloads import Workload

if TYPE_CHECKING:  # circular at runtime: selector.py imports this module
    from repro_torch.core.selector import Selection

__all__ = ["SelectionTable", "merge_breakpoints", "build_selection_table"]

# Element budget of one fused sweep chunk (candidates x breakpoints): the
# (C, B) cost matrix is evaluated in column blocks so extending a table to
# a large m_max stays at tens of MB of intermediates, not gigabytes.
_SWEEP_CHUNK_ELEMS = 1 << 23


def merge_breakpoints(periods: Sequence[int], m_max: int) -> list[int]:
    """Sorted, deduped interval starts partitioning [1, m_max].

    The cost vector is constant on [j*t + 1, (j+1)*t] for every period t,
    so the starts are 1 plus every j*t + 1 <= m_max.  The arithmetic
    progressions are materialized directly and merged with one vectorized
    unique — divisor-free: nothing ever touches the integers in between
    (the old ``selections_upto`` built a Python set of ALL multiples).
    """
    streams = [np.asarray([1], np.int64)]
    for t in sorted({int(t) for t in periods}):
        if t >= 1:
            streams.append(np.arange(t + 1, m_max + 1, t, dtype=np.int64))
    return np.unique(np.concatenate(streams)).tolist()


@dataclasses.dataclass(frozen=True)
class SelectionTable:
    """Sorted ``starts -> Selection`` array covering every M in [1, m_max].

    ``starts`` is strictly increasing with ``starts[0] == 1``; entry ``i``
    serves all M in [starts[i], starts[i+1]) (the last entry serves up to
    ``m_max``).  Lookup is a bisect on a plain Python list: the serving hot
    path does no numpy and allocates nothing.
    """

    m_max: int
    starts: list[int]  # interval start per entry, strictly increasing
    entries: list  # Selection per entry (one per merged interval)
    num_intervals: int  # breakpoint intervals swept (pre-merge)
    build_seconds: float

    def __len__(self) -> int:
        return len(self.entries)

    def covers(self, m: int) -> bool:
        return 1 <= m <= self.m_max

    def lookup(self, m: int) -> "Selection":
        """The materialized selection for M = ``m`` (requires covers(m))."""
        return self.entries[bisect.bisect_right(self.starts, m) - 1]


def build_selection_table(
    hw: HardwareSpec,
    wl: Workload,
    stacked: StackedLattices,
    m_max: int,
    num_cores: int = 1,
) -> SelectionTable:
    """Sweep the breakpoint set once and materialize the selection table.

    One ``runtime_cost_matrix`` call scores every (backend-stacked)
    candidate at every interval representative; everything after the argmin
    is integer bookkeeping.  Intervals whose winner and launch grid both
    repeat are merged (the grid is constant within an interval by
    construction — every dynamic-axis tile extent is a period — so equal
    (winner, grid) pairs imply byte-identical Selections).
    """
    from repro_torch.core.selector import Selection

    t0 = time.perf_counter()
    m_max = max(int(m_max), 1)
    periods = stacked.dynamic_periods(wl.dynamic_tile_axes)
    starts = merge_breakpoints(periods, m_max)
    reps = np.asarray(starts, np.float64)

    n_b = len(starts)
    winners = np.empty(n_b, np.int64)
    win_costs = np.empty(n_b, np.float64)
    chunk = max(1, _SWEEP_CHUNK_ELEMS // max(stacked.num_candidates, 1))
    for lo in range(0, n_b, chunk):
        costs = runtime_cost_matrix(
            hw, wl, stacked.l1_tiles, stacked.l1_costs,
            reps[lo:lo + chunk], num_cores,
        )
        w = np.argmin(costs, axis=0)
        winners[lo:lo + chunk] = w
        win_costs[lo:lo + chunk] = costs[w, np.arange(costs.shape[1])]

    M, N, K = wl.runtime_dims(reps)
    tiles = stacked.l1_tiles[winners].astype(np.float64)  # (B, 3)
    gm = np.ceil(np.asarray(M, np.float64) / tiles[:, 0]).astype(np.int64)
    gn = np.ceil(np.asarray(N, np.float64) / tiles[:, 1]).astype(np.int64)
    gk = np.ceil(np.asarray(K, np.float64) / tiles[:, 2]).astype(np.int64)

    # Merge consecutive intervals with identical (winner, grid): only the
    # change points materialize a Selection (vectorized change detection —
    # the sweep may cover hundreds of thousands of intervals, the merged
    # table typically holds a few hundred entries).
    keys = np.stack([winners, gm, gn, gk], axis=1)  # (B, 4)
    change = np.ones(n_b, bool)
    change[1:] = np.any(keys[1:] != keys[:-1], axis=1)

    out_starts: list[int] = []
    out_entries: list[Selection] = []
    for b in np.flatnonzero(change):
        idx = int(winners[b])
        strategy = stacked.strategy_for(idx)
        grid = (int(gm[b]), int(gn[b]), int(gk[b]))
        out_starts.append(int(starts[b]))
        out_entries.append(
            Selection(
                strategy=strategy,
                backend=stacked.backend_of(idx),
                grid=grid,
                padded_m=grid[0] * strategy.l1[0],
                bucket=wl.bucket_dims(grid, strategy.l1),
                predicted_cost=float(win_costs[b]),
                select_seconds=0.0,  # amortized: see SelectorStats
            )
        )

    return SelectionTable(
        m_max=m_max,
        starts=out_starts,
        entries=out_entries,
        num_intervals=len(starts),
        build_seconds=time.perf_counter() - t0,
    )
