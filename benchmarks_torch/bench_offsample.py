"""Paper Fig. 3 / Table 6 — off-sample degradation of sample-driven tuning,
on the port.

The sample-driven compiler is tuned for M in [128, 256) (the paper's
Table 6 setup); runtime M sweeps [1, 384).  Vortex (sample-free, the
hand-written ``vortex_gemm`` on the card) should show a larger advantage
on the ranges OUTSIDE the tuned window, where the sampled kernel pads M
to its sample's shape (a generic ``torch.matmul`` at the padded M).

    python benchmarks_torch/bench_offsample.py [--device cpu]
"""
from __future__ import annotations

import sys
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
from repro_torch.core.baselines import SampleDrivenCompiler  # noqa: E402
from repro_torch.vortex import Engine  # noqa: E402

N, K = 768, 2304 // 2  # the reference's BERT GEMM (K halved)


def main() -> None:
    device = bench_args().device
    hardware = hardware_for(device)
    wl = GemmWorkload(M=None, N=N, K=K)
    vortex = Engine(hardware, device=device).compile(wl).kernel
    sampled = SampleDrivenCompiler(
        get_hardware(hardware), wl, samples=[128, 160, 192, 224, 255],
        search_budget=3, repeats=2, device=device, dtype=dtype_for(device),
    )
    rng = np.random.default_rng(1)
    ranges = {"in[128,256)": range(130, 256, 25),
              "out[0,128)": range(5, 128, 24),
              "out[256,384)": range(260, 384, 25)}
    for label, ms in ranges.items():
        sps, pads = [], []
        for m in ms:
            a = randn(rng, (m, K), device)
            b = randn(rng, (K, N), device)
            t_v = time_call(vortex, a, b, repeats=3)
            t_s = time_call(sampled, a, b, repeats=3)
            sps.append(t_s / t_v)
            pads.append(sampled.padded_m(m) / m)
        emit(
            f"offsample/{label}", 0.0,
            f"avg_speedup={np.mean(sps):.3f};"
            f"avg_pad_ratio_sampled={np.mean(pads):.2f}",
        )


if __name__ == "__main__":
    main()
