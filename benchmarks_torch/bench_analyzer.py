"""Paper Table 7 — hybrid-analyzer configuration study, on the port.

Offline overhead and selection quality for the analyzer configurations:
host CPU default (E: L0) vs changed (E: L0,L1), measured by wall-clock on
the CPU; H100 default (E: L0,L1 through the hardware's profiled table) vs
changed (E: L0) vs analytical-only.  Quality is the predicted-cost regret
of the selected strategies against the H100 default.  It only prices and
profiles on the host, so it needs no card.

    python benchmarks_torch/bench_analyzer.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks_torch.util import emit  # noqa: E402
from repro_torch.core import (  # noqa: E402
    H100_SXM,
    HOST_CPU,
    GemmWorkload,
    TableProfiler,
    VortexKernel,
    WallClockProfiler,
)

N, K = 768, 1152
MS = [7, 40, 128, 300, 777]


def main() -> None:
    wl = GemmWorkload(M=None, N=N, K=K)
    cpu_prof = WallClockProfiler(device="cpu")
    h100_prof = TableProfiler(H100_SXM)
    configs = [
        ("cpu/E_L0", HOST_CPU, cpu_prof, (0,), ("simd",)),
        ("cpu/E_L0L1", HOST_CPU, cpu_prof, (0, 1), ("simd",)),
        ("h100/E_L0L1", H100_SXM, h100_prof, (0, 1), ("tensor_core",)),
        ("h100/E_L0", H100_SXM, h100_prof, (0,), ("tensor_core",)),
        ("h100/analytical", H100_SXM, h100_prof, (), ("tensor_core",)),
    ]
    preds = {}
    for name, hw, prof, levels, backends in configs:
        t0 = time.perf_counter()
        kern = VortexKernel(
            hw, wl, impl="torch", profiler=prof, empirical_levels=levels,
            backends=backends,
            num_cores=hw.level(hw.num_levels - 1).parallel_units,
        )
        offline = time.perf_counter() - t0
        cost = float(np.mean([kern.select(m).predicted_cost for m in MS]))
        preds[name] = cost
        emit(
            f"analyzer/{name}", offline * 1e6,
            f"measured={kern.offline_stats.num_measured};"
            f"mean_predicted_cost={cost:.3e}",
        )
    base = preds["h100/E_L0L1"]
    for name in ("h100/E_L0", "h100/analytical"):
        emit(
            f"analyzer/{name}/regret", 0.0,
            f"predicted_cost_ratio={preds[name] / base:.3f}",
        )


if __name__ == "__main__":
    main()
