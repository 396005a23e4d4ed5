"""Paper Fig. 15 — hierarchical kernel construction ablation, on the port.

Vortex (dynamic strategies at every level) vs:
  * Vortex-Static1: the L0 child is frozen to one tile; L1 stays dynamic
    (the lattice is re-scored with only that child available);
  * Vortex-Static2: L0 AND L1 frozen — one strategy for every shape;
  * Vortex-Oracle: per-shape exhaustive wall-clock search over the
    lattice's M-tile buckets.

As in the reference, a tile sets the padded M of a generic matmul
(``torch.matmul`` in place of the XLA dot), so the variants differ only
in the padding their tile choices imply.  Reported as fraction of
Oracle wall-clock.  Every padded shape is run once untimed the first time
it is seen (a memoized warm call, the counterpart of the reference's
memoized executables), so a first call never lands in a timed window.

    python benchmarks_torch/bench_hierarchy.py [--device cpu]
"""
from __future__ import annotations

import collections
import math
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks_torch.util import (  # noqa: E402
    bench_args,
    emit,
    hardware_for,
    randn,
    time_call,
)
from repro_torch.core import (  # noqa: E402
    TableProfiler,
    WallClockProfiler,
    get_hardware,
)
from repro_torch.core.analyzer import HybridAnalyzer  # noqa: E402
from repro_torch.core.candidates import (  # noqa: E402
    CandidateLattice,
    generate_lattice,
)
from repro_torch.core.selector import RuntimeSelector  # noqa: E402
from repro_torch.core.workloads import GemmWorkload  # noqa: E402
from repro_torch.core.timing import synchronize  # noqa: E402
from repro_torch.vortex import Engine  # noqa: E402

N, K = 512, 1024
MS = [3, 17, 40, 77, 128, 200, 311, 450]


class _PaddedMatmul:
    """``torch.matmul`` at a padded M, warmed once per padded shape."""

    def __init__(self, b: torch.Tensor):
        self._b = b
        self._warm: set[int] = set()

    def __call__(self, mp: int, a: torch.Tensor) -> torch.Tensor:
        m = a.shape[0]
        if mp not in self._warm:
            synchronize(torch.matmul(
                a.new_zeros((mp, a.shape[1])), self._b))
            self._warm.add(mp)
        if mp != m:
            a = F.pad(a, (0, 0, 0, mp - m))
        out = torch.matmul(a, self._b)
        return out[:m] if mp != m else out


def _measure(run, tile_for, mats):
    out = {}
    for m, a in mats.items():
        tm = tile_for(m)
        mp = math.ceil(m / tm) * tm
        out[m] = time_call(lambda a_: run(mp, a_), a, repeats=3)
    return out


def main() -> None:
    device = bench_args().device
    hardware = hardware_for(device)
    hw = get_hardware(hardware)
    backend = hw.default_backend
    wl = GemmWorkload(M=None, N=N, K=K)
    vortex = Engine(hardware, device=device,
                    backends=(backend,)).compile(wl).kernel
    rng = np.random.default_rng(0)
    mats = {m: randn(rng, (m, K), device) for m in MS}
    run = _PaddedMatmul(randn(rng, (K, N), device))

    # Oracle: per-shape best wall-clock over the lattice's m-tile buckets.
    tiles = sorted({
        int(t[0]) for t in vortex.selector.scored[backend].l1_tiles
    })
    tiles = [t for t in tiles if t <= 1024][:10]
    oracle_t = {}
    for m in MS:
        best = float("inf")
        for tm in tiles:
            mp = math.ceil(m / tm) * tm
            best = min(best, time_call(lambda a_: run(mp, a_), mats[m],
                                       repeats=3))
        oracle_t[m] = best

    # Vortex: dynamic at every level.
    vortex_t = _measure(run, lambda m: vortex.select(m).strategy.l1[0], mats)

    # Static1: freeze L0 to the most-chosen child over the full workload
    # range, rescore the lattice with only that child, keep L1 dynamic.
    sels = [vortex.select(m) for m in MS + [512, 1024, 2048, 4096, 8192]]
    l0_common = collections.Counter(
        s.strategy.tiles[0] for s in sels
    ).most_common(1)[0][0]
    full = generate_lattice(hw, wl, backend)
    kept = {
        l1: (l0_common,)
        for l1 in full.l1
        if all(a % b == 0 for a, b in zip(l1, l0_common))
    }
    frozen = CandidateLattice(
        backend=backend,
        layers=((l0_common,), tuple(kept)),
        children=({}, kept),
    )
    profiler, levels = (
        (TableProfiler(hw), (0, 1)) if hardware == "h100_sxm"
        else (WallClockProfiler(device="cpu"), (0,))
    )
    scored1 = HybridAnalyzer(
        hw, wl, profiler=profiler, empirical_levels=levels
    ).score(frozen)
    sel1 = RuntimeSelector(
        hw, wl, {backend: scored1},
        num_cores=hw.level(hw.num_levels - 1).parallel_units,
    )
    static1_t = _measure(run, lambda m: sel1.select(m).strategy.l1[0], mats)

    # Static2: freeze L0 and L1 to the single most-chosen full strategy.
    l1_common = collections.Counter(
        s.strategy.l1 for s in sels
    ).most_common(1)[0][0]
    static2_t = _measure(run, lambda m: l1_common[0], mats)

    def frac(ts):
        return float(np.mean([oracle_t[m] / ts[m] for m in MS]))

    emit("hierarchy/vortex", 0.0, f"frac_of_oracle={frac(vortex_t):.3f}")
    emit("hierarchy/static1", 0.0, f"frac_of_oracle={frac(static1_t):.3f}")
    emit("hierarchy/static2", 0.0, f"frac_of_oracle={frac(static2_t):.3f}")


if __name__ == "__main__":
    main()
