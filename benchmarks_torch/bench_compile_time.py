"""Paper §7.4 'Offline Overhead Analysis' on the port — candidate counts and
offline seconds, Vortex vs sample-driven tuning.

Vortex's offline stage is timed for (a) host-CPU empirical-L0 (wall-clock
on the CPU), (b) the H100 lattice with its profiled table at L0+L1 over
both backends, (c) H100 analytical-only; then the sample-driven tuner
(``SampleDrivenCompiler``: an empirical M-tile search per sample, timing
the padded ``torch.matmul`` on the device) on a growing sample list.
``torch.matmul`` compiles nothing per shape, so the tuner's seconds are
its measurements alone (the reference's also pay one XLA compile per
padded shape).

    python benchmarks_torch/bench_compile_time.py [--device cpu]
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks_torch.util import (  # noqa: E402
    bench_args,
    dtype_for,
    emit,
    hardware_for,
)
from repro_torch.core import (  # noqa: E402
    H100_SXM,
    HOST_CPU,
    GemmWorkload,
    TableProfiler,
    VortexKernel,
    WallClockProfiler,
)
from repro_torch.core.baselines import SampleDrivenCompiler  # noqa: E402
from repro_torch.core.timing import synchronize  # noqa: E402

N, K = 768, 2304


def main() -> None:
    device = bench_args().device
    wl = GemmWorkload(M=None, N=N, K=K)
    sms = H100_SXM.level(H100_SXM.num_levels - 1).parallel_units
    modes = {
        "cpu_empirical_L0": dict(
            hw=HOST_CPU, profiler=WallClockProfiler(device="cpu"),
            empirical_levels=(0,), backends=("simd",),
        ),
        "h100_table_L0L1": dict(
            hw=H100_SXM, profiler=TableProfiler(H100_SXM),
            empirical_levels=(0, 1), backends=("tensor_core", "cuda_core"),
            num_cores=sms,
        ),
        "h100_analytical": dict(
            hw=H100_SXM, empirical_levels=(), backends=("tensor_core",),
            num_cores=sms,
        ),
    }
    vortex_seconds = {}
    for name, kw in modes.items():
        hw = kw.pop("hw")
        t0 = time.perf_counter()
        kern = VortexKernel(hw, wl, impl="torch", **kw)
        dt = time.perf_counter() - t0
        vortex_seconds[name] = dt
        emit(
            f"compile_time/vortex/{name}", dt * 1e6,
            f"candidates={kern.offline_stats.num_candidates};"
            f"measured={kern.offline_stats.num_measured}",
        )

    hw, base = (H100_SXM, "h100_table_L0L1") \
        if hardware_for(device) == "h100_sxm" \
        else (HOST_CPU, "cpu_empirical_L0")
    # The process's first matmul on the device creates its context and
    # library handles; keep that out of the first tuner's seconds.
    a = torch.zeros((64, 64), device=device, dtype=dtype_for(device))
    synchronize(torch.matmul(a, a))
    for n_samples in (2, 4, 8):
        samples = [32 * (i + 1) for i in range(n_samples)]
        sampled = SampleDrivenCompiler(
            hw, wl, samples, search_budget=4, repeats=2, device=device,
            dtype=dtype_for(device),
        )
        dt = sampled.tuning_seconds
        emit(
            f"compile_time/sample_driven/{n_samples}samples", dt * 1e6,
            f"slowdown_vs_vortex_{base}="
            f"{dt / max(vortex_seconds[base], 1e-9):.3f}x",
        )


if __name__ == "__main__":
    main()
