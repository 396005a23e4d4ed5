"""Paper Fig. 16 — dynamic hardware adaptation: tensor cores vs CUDA cores
on the H100 (the paper's own GPU setting; the reference prices the TPU's
MXU vs VPU).

For tiny M a wgmma tile pads M to 64 rows and wastes most of the tensor
core; the CUDA-core (FMA) path has no such granularity.  The adaptive
selector must match the better of the two fixed settings for every
(M, N) point.  Analytical costs on the H100 spec (the decision function
the runtime uses); it only prices, so it needs no device.

    python benchmarks_torch/bench_adaptive.py
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks_torch.util import emit  # noqa: E402
from repro_torch.core import H100_SXM, GemmWorkload, VortexKernel  # noqa: E402

K = 1024
SMS = H100_SXM.level(H100_SXM.num_levels - 1).parallel_units


def _kernel(wl, backends):
    return VortexKernel(H100_SXM, wl, impl="torch", backends=backends,
                        num_cores=SMS)


def main() -> None:
    for N in (1024, 2048, 4096):
        wl = GemmWorkload(M=None, N=N, K=K)
        both = _kernel(wl, ("tensor_core", "cuda_core"))
        tc = _kernel(wl, ("tensor_core",))
        cc = _kernel(wl, ("cuda_core",))
        gains_tc, gains_cc, routed_cc = [], [], 0
        for m in range(1, 17):
            c_a = both.select(m).predicted_cost
            c_t = tc.select(m).predicted_cost
            c_c = cc.select(m).predicted_cost
            assert c_a <= min(c_t, c_c) * 1.0001
            gains_tc.append(c_t / c_a)
            gains_cc.append(c_c / c_a)
            routed_cc += both.select(m).backend == "cuda_core"
        emit(
            f"adaptive/N{N}", 0.0,
            f"max_gain_vs_tensor_core_only={max(gains_tc):.2f};"
            f"max_gain_vs_cuda_core_only={max(gains_cc):.2f};"
            f"cuda_core_routed={routed_cc}/16",
        )


if __name__ == "__main__":
    main()
