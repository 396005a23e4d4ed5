"""Paper Fig. 14 — runtime overhead breakdown, on the port.

The runtime cost-model evaluation must be microseconds-scale and a small
fraction of kernel execution.  The selector is timed in isolation (cold =
first evaluation of a new M, warm = repeated M) and compared with one
engine call (selection + one ``vortex_gemm`` launch, synchronized) at
M = N = K = 64, 256 and 1024, bf16 on the card.

    python benchmarks_torch/bench_runtime_overhead.py [--device cpu]
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks_torch.util import (  # noqa: E402
    bench_args,
    emit,
    hardware_for,
    randn,
    time_call,
)
from repro_torch.vortex import Engine  # noqa: E402


def main() -> None:
    device = bench_args().device
    for size in (64, 256, 1024):
        eng = Engine(hardware_for(device), device=device)
        kern = eng.compile("gemm", M=None, N=size, K=size).kernel
        # cold selection: fresh M values
        n_cold = 200
        t0 = time.perf_counter()
        for m in range(1, n_cold + 1):
            kern.selector.select(m)
        cold_us = (time.perf_counter() - t0) / n_cold * 1e6
        # warm selection: repeated M
        t0 = time.perf_counter()
        for _ in range(n_cold):
            kern.selector.select(7)
        warm_us = (time.perf_counter() - t0) / n_cold * 1e6
        rng = np.random.default_rng(0)
        a = randn(rng, (size, size), device)
        b = randn(rng, (size, size), device)
        exec_us = time_call(kern, a, b) * 1e6
        emit(
            f"runtime_overhead/MNK{size}", exec_us,
            f"select_cold_us={cold_us:.1f};select_warm_us={warm_us:.2f};"
            f"overhead_frac={cold_us / max(exec_us, 1e-9):.3f}",
        )


if __name__ == "__main__":
    main()
