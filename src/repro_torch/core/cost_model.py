"""Analytical cost model (paper §5.2, Eqs. 2-4), workload-generic.

The model is recursive over rKernel layers.  At layer L, with a serial
(temporal) loop of ``n`` iterations whose body is the layer-(L-1) kernel:

    T_temporal = T_load + (n - 1) * max(T_load, Cost_{L-1})
                 + Cost_{L-1} + T_store                          (Eq. 2)

i.e. a software pipeline: the first load is exposed, then loads overlap with
compute, and the last body + store drain the pipe.  Parallel loops amplify by
the ceil-division occupancy factor:

    F_parallel = ceil(|ParallelLoop| / |HardwareUnit|)           (Eq. 3)
    Cost_L     = F_parallel * T_temporal                         (Eq. 4)

Level-0 cost comes from the analyzer (empirical where available, else the
native-tile analytical estimate here), so this module exposes the recursion
with an injectable ``cost_l0`` — the hybrid split of §5.2.

The recursion itself is workload-agnostic: concrete (M, N, K) dims come from
``wl.runtime_dims`` and grid-level traffic from ``wl.tile_traffic_bytes``
(workloads.py), so GEMM, attention and conv all evaluate through the same
Eq. 2-4 arithmetic.  ``gemm_strategy_cost``/``gemm_runtime_costs`` remain as
aliases of the generic entry points.

All costs are seconds.  A vectorized (numpy) evaluator over many layer-1
candidates is provided for the runtime selector, whose overhead must stay
negligible (paper Fig. 14).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.rkernel import Strategy
from repro_torch.core.workloads import Workload

__all__ = [
    "CostBreakdown",
    "l0_analytical_cost",
    "strategy_cost",
    "runtime_costs",
    "runtime_cost_matrix",
]


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """Per-layer decomposition of a strategy's predicted cost."""

    total: float
    l0_per_tile: float
    l1_per_tile: float
    f_parallel: float
    padded_shape: tuple[int, int, int]
    padding_waste: float  # fraction of computed FLOPs that are padding


def l0_analytical_cost(
    hw: HardwareSpec, tile: tuple[int, int, int], backend: str
) -> float:
    """Analytical level-0 cost of one native-tile-group contraction.

    Models the systolic array: a tile smaller than the native granularity
    still occupies a full native issue, so cost is the *padded* tile's FLOPs
    over peak — this is where low-utilization candidates get their penalty
    (paper Fig. 5) before any empirical correction.
    """
    bm, bn, bk = hw.native_tile[backend]
    m, n, k = tile
    pm, pn, pk = (
        math.ceil(m / bm) * bm,
        math.ceil(n / bn) * bn,
        math.ceil(k / bk) * bk,
    )
    peak = hw.backends[backend]
    issue_overhead = 5e-9  # fixed per-issue latency (pipeline fill)
    return 2.0 * pm * pn * pk / peak + issue_overhead


def _t_temporal(
    t_load: float, n_iter: float, body: float, t_store: float
) -> float:
    """Eq. 2 with a guard for degenerate 0-iteration loops."""
    if n_iter <= 0:
        return 0.0
    return t_load + (n_iter - 1.0) * max(t_load, body) + body + t_store


def strategy_cost(
    hw: HardwareSpec,
    wl: Workload,
    strategy: Strategy,
    m_runtime: int | None = None,
    cost_l0: float | None = None,
    num_cores: int = 1,
    dims: tuple[int, int, int] | None = None,
) -> CostBreakdown:
    """Full Eq. 2-4 recursion for a strategy at a concrete shape.

    ``cost_l0`` overrides the analytical level-0 estimate with an empirical
    measurement (the hybrid analyzer passes it in).  ``num_cores`` is the
    level-2 |HardwareUnit| — TensorCores across the shard this runs on.
    ``dims`` overrides the workload's runtime (M, N, K) view entirely — the
    analyzer uses it to cost ONE layer-1 tile (grid = 1x1x1).
    """
    M, N, K = dims if dims is not None else wl.runtime_dims(m_runtime)
    m0, n0, k0 = strategy.l0
    m1, n1, k1 = strategy.l1

    c0 = cost_l0 if cost_l0 is not None else l0_analytical_cost(
        hw, strategy.l0, strategy.backend
    )

    # ---- layer 1: temporal-spatial (m, n) x temporal-reduction (k) over
    # level-0 tiles, operands already in VMEM.
    l0_iters_k = k1 // k0
    l0_iters_sp = (m1 // m0) * (n1 // n0)
    reg_bw = hw.level(0).load_bandwidth
    t_load0 = (m0 * k0 + k0 * n0) * wl.dtype_bytes / reg_bw
    t_store0 = 0.0  # accumulator stays resident in VREG/VMEM across k
    inner_chain = _t_temporal(t_load0, l0_iters_k, c0, t_store0)
    cost_l1_tile = l0_iters_sp * inner_chain  # spatial tiles run back-to-back

    # ---- layer 2: grid. Parallel loops over ceil(M/m1) * ceil(N/n1)
    # instances on num_cores cores; temporal reduction over ceil(K/k1)
    # steps, each streaming the workload's per-tile operands from HBM.
    gm, gn, gk = (
        math.ceil(M / m1),
        math.ceil(N / n1),
        math.ceil(K / k1),
    )
    hbm_bw = hw.level(1).load_bandwidth
    load_bytes, store_bytes = wl.tile_traffic_bytes(m1, n1, k1)
    t_load1 = load_bytes / hbm_bw
    t_store1 = store_bytes / hbm_bw
    t_tile = _t_temporal(t_load1, gk, cost_l1_tile, t_store1)
    f_parallel = math.ceil(gm * gn / max(num_cores, 1))  # Eq. 3
    total = f_parallel * t_tile  # Eq. 4

    padded = (gm * m1, gn * n1, gk * k1)
    useful = 2.0 * M * N * K
    waste = 1.0 - useful / (2.0 * padded[0] * padded[1] * padded[2])
    return CostBreakdown(
        total=total,
        l0_per_tile=c0,
        l1_per_tile=cost_l1_tile,
        f_parallel=f_parallel,
        padded_shape=padded,
        padding_waste=waste,
    )


def runtime_cost_matrix(
    hw: HardwareSpec,
    wl: Workload,
    l1_tiles: np.ndarray,
    l1_costs: np.ndarray,
    ms: np.ndarray,
    num_cores: int = 1,
    cost_scale: np.ndarray | None = None,
) -> np.ndarray:
    """Fused Eq. 2-4 sweep: C candidates x B runtime extents -> (C, B).

    ``l1_tiles`` may stack candidates from MANY backends — the grid-level
    recursion only consumes the per-tile cost ``l1_costs`` (which already
    encodes the backend's level-0/1 behaviour), so one numpy evaluation
    covers the whole multi-backend strategy space.  ``ms`` is a vector of
    dynamic extents; the offline table builder passes every breakpoint at
    once, the runtime argmin fallback passes a single element.

    Every arithmetic op is elementwise, so the (C,) column at ``ms=[m]`` is
    bit-identical to the same column of a wider sweep containing ``m`` —
    the table/argmin equivalence tests rely on this.

    ``cost_scale`` is an optional (C,) per-candidate multiplier on the
    final cost — the background calibrator's refined per-backend
    coefficients (core/calibrate.py).  A constant scale preserves the
    piecewise-constant-in-M structure (breakpoints are unchanged), so a
    calibrated selection table is built by the exact same sweep.
    """
    ms = np.atleast_1d(np.asarray(ms, np.float64))
    M, N, K = wl.runtime_dims(ms)
    m1 = l1_tiles[:, 0:1].astype(np.float64)  # (C, 1)
    n1 = l1_tiles[:, 1:2].astype(np.float64)
    k1 = l1_tiles[:, 2:3].astype(np.float64)
    gm = np.ceil(M / m1)  # (C, B)
    gn = np.ceil(N / n1)  # (C, 1) static dims, (C, B) dynamic-tied ones
    gk = np.ceil(K / k1)
    hbm_bw = hw.level(1).load_bandwidth
    load_bytes, store_bytes = wl.tile_traffic_bytes(m1, n1, k1)
    t_load = load_bytes / hbm_bw
    t_store = store_bytes / hbm_bw
    body = l1_costs[:, None]
    t_tile = t_load + np.maximum(gk - 1.0, 0.0) * np.maximum(t_load, body) \
        + body + t_store
    f_parallel = np.ceil(gm * gn / max(num_cores, 1))
    out = f_parallel * t_tile
    if cost_scale is not None:
        out = out * np.asarray(cost_scale, np.float64)[:, None]
    return np.broadcast_to(out, (l1_tiles.shape[0], ms.shape[0]))


def runtime_costs(
    hw: HardwareSpec,
    wl: Workload,
    l1_tiles: np.ndarray,
    l1_costs: np.ndarray,
    m_runtime: int,
    num_cores: int = 1,
    cost_scale: np.ndarray | None = None,
) -> np.ndarray:
    """Vectorized layer-2 cost over many layer-1 candidates at runtime.

    ``l1_tiles`` is (C, 3) int — possibly backend-stacked (see
    :class:`~repro_torch.core.analyzer.StackedLattices`); ``l1_costs`` is (C,)
    seconds per layer-1 tile (precomputed offline by the analyzer — at
    runtime only the cheap Eq. 2-4 arithmetic at the grid level runs,
    keeping selection overhead at the microsecond scale Fig. 14 demands).
    """
    return runtime_cost_matrix(
        hw, wl, l1_tiles, l1_costs, np.asarray([m_runtime]), num_cores,
        cost_scale,
    )[:, 0]
