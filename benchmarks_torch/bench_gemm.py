"""Paper Fig. 12 / Table 5 — operator-level dynamic-shape GEMM performance,
on the port (bf16 on the card).

Per category (the reference's three cases at their N and K: transformer
768x768, CNN 512x1152, GNN 64x256), at every M of its stream:

  * steady state: best-of-N per-call wall-clock (host dispatch plus device
    time, each call synchronized) with warm executables, Vortex
    (``VortexKernel`` on the H100 lattice: selection + the hand-written
    ``vortex_gemm``) against the vendor library (``torch.matmul`` at the
    exact shape: cuBLAS) and the sample-driven compiler (padded
    ``torch.matmul`` at its nearest sample's shape);
  * dynamic stream: every M served once by fresh engines, first-call
    costs included (Vortex's lattice build and selection; the kernel
    library is built by then).

Vortex latency always includes its runtime selection (§7.2).

    python benchmarks_torch/bench_gemm.py [--device cpu]
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks_torch.util import (  # noqa: E402
    bench_args,
    dtype_for,
    emit,
    hardware_for,
    randn,
    time_call,
)
from repro_torch.core import GemmWorkload, get_hardware  # noqa: E402
from repro_torch.core.baselines import (  # noqa: E402
    SampleDrivenCompiler,
    VendorBaseline,
)
from repro_torch.core.timing import synchronize  # noqa: E402
from repro_torch.vortex import Engine  # noqa: E402

# (category, N, K, M values) — the reference's cases.
CASES = [
    ("transformer", 768, 768, [5, 33, 63, 128, 200, 381]),
    ("cnn", 512, 1152, [1, 7, 49, 96]),
    ("gnn", 64, 256, [500, 1111, 2708]),
]


def _stream_seconds(engine, mats) -> float:
    t0 = time.perf_counter()
    for a, b in mats:
        synchronize(engine(a, b))
    return time.perf_counter() - t0


def main() -> None:
    device = bench_args().device
    hardware = hardware_for(device)
    hw = get_hardware(hardware)

    def vortex_kernel(wl):
        return Engine(hardware, device=device).compile(wl).kernel

    steady_v, steady_s, stream_sp, n = 0.0, 0.0, [], 0
    for cat, N, K, ms in CASES:
        wl = GemmWorkload(M=None, N=N, K=K)
        rng = np.random.default_rng(0)
        mats = [(randn(rng, (m, K), device), randn(rng, (K, N), device))
                for m in ms]

        # --- steady state (warm executables) ---------------------------
        vortex = vortex_kernel(wl)
        vendor = VendorBaseline(wl)
        sampled = SampleDrivenCompiler(
            hw, wl, samples=[ms[len(ms) // 2]], search_budget=3, repeats=2,
            device=device, dtype=dtype_for(device),
        )
        for (a, b), m in zip(mats, ms):
            t_vortex = time_call(vortex, a, b)
            t_vendor = time_call(vendor, a, b)
            t_sampled = time_call(sampled, a, b)
            steady_v += t_vendor / t_vortex
            steady_s += t_sampled / t_vortex
            n += 1
            emit(
                f"gemm/{cat}/M{m}", t_vortex * 1e6,
                f"vendor_us={t_vendor * 1e6:.2f};"
                f"sampled_us={t_sampled * 1e6:.2f};"
                f"steady_speedup_vs_vendor={t_vendor / t_vortex:.3f};"
                f"steady_speedup_vs_sampled={t_sampled / t_vortex:.3f}",
            )

        # --- dynamic stream (fresh engines, first calls included) -------
        t_vx = _stream_seconds(vortex_kernel(wl), mats)
        t_vd = _stream_seconds(VendorBaseline(wl), mats)
        stream_sp.append(t_vd / t_vx)
        emit(
            f"gemm/{cat}/dynamic_stream", t_vx / len(ms) * 1e6,
            f"stream_speedup_vs_exact_shape={t_vd / t_vx:.3f}",
        )

    emit(
        "gemm/average", 0.0,
        f"steady_speedup_vendor={steady_v / n:.3f};"
        f"steady_speedup_sampled={steady_s / n:.3f};"
        f"stream_speedup_vendor={float(np.mean(stream_sp)):.3f}",
    )


if __name__ == "__main__":
    main()
