"""Hardware hierarchy descriptors for Vortex's strategy-space hierarchization.

The paper (§2.3, §4) observes that CPUs and GPUs share a multi-level
hierarchical structure — each level has a fixed number of compute/storage
units, and kernel performance collapses when a strategy's resource usage at
any level exceeds that level's limit.  Vortex encodes those limits explicitly
and uses them to prune the strategy space *before* any profiling.

The port's target is the NVIDIA H100 SXM (:data:`H100_SXM`), the paper's
own GPU adaptation (§6.2, Fig. 16):

  level 2  "grid"   — a grid of thread blocks over the 132 SMs,
  level 1  "smem"   — a block's tile resident in SM shared memory,
                      streamed from HBM,
  level 0  "wgmma"  — the warpgroup tile held in registers.

The reference's :data:`TPU_V5E` and :data:`HOST_CPU` specs are kept field
for field, so the port's lattices, tables and buckets can be held against
the JAX package's one for one.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

__all__ = [
    "HardwareLevel",
    "HardwareSpec",
    "TPU_V5E",
    "HOST_CPU",
    "H100_SXM",
    "get_hardware",
]


@dataclasses.dataclass(frozen=True)
class HardwareLevel:
    """One level of the hardware hierarchy (paper Table 1 rows).

    Attributes:
      depth: level index; 0 is the innermost (ISA/compute) level.
      name: human-readable level name ("mxu", "vmem", "grid", ...).
      parallel_units: number of sibling units that execute in parallel at
        this level (Eq. 3's |HardwareUnit|).  1 for purely temporal levels.
      capacity_bytes: storage capacity available to ONE unit at this level
        (VMEM bytes, cache bytes, register-file bytes).  ``None`` when the
        level has no explicit working-set limit (e.g. the grid level).
      load_bandwidth: bytes/s from the parent level's memory into this
        level's memory (HBM→VMEM, DRAM→cache, ...).  Used for T_Load/T_Store
        in Eq. 2.
      compute_flops: peak FLOP/s of ONE unit at this level; only meaningful
        at depth 0 (the level that actually computes).
    """

    depth: int
    name: str
    parallel_units: int
    capacity_bytes: int | None
    load_bandwidth: float
    compute_flops: float = 0.0


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """A full hardware target: an ordered hierarchy plus ISA granularities.

    Attributes:
      name: target name.
      levels: levels ordered by depth (levels[0].depth == 0).
      native_tile: per-backend ISA granularity for level-0 candidates, as a
        mapping from backend name to an (m, n, k) tile that level-0 candidate
        dims must be multiples of (paper's FilterByISA: AVX512 lanes on CPU,
        MMA m16n8k16 on GPU; wgmma m64n8k16 on the H100).
      backends: compute backends selectable at runtime (§6.2 "dynamic
        hardware adaptation": CUDA core vs Tensor Core on GPU; MXU vs VPU
        on the TPU).  Maps backend name -> peak FLOP/s of one level-0 unit group.
      link_bandwidth: per-chip interconnect bandwidth (ICI), bytes/s; used by
        the roofline collective term, not by single-chip strategy costs.
      min_utilization: strategies whose level-0 occupancy of the native tile
        falls below this are pruned (paper Fig. 5: extremely low utilization
        configs always underperform).
    """

    name: str
    levels: tuple[HardwareLevel, ...]
    native_tile: Mapping[str, tuple[int, int, int]]
    backends: Mapping[str, float]
    link_bandwidth: float
    min_utilization: float = 0.03125

    def level(self, depth: int) -> HardwareLevel:
        return self.levels[depth]

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def default_backend(self) -> str:
        return next(iter(self.backends))


def _tpu_v5e() -> HardwareSpec:
    # Roofline constants fixed by the assignment: 197 TFLOP/s bf16,
    # 819 GB/s HBM, ~50 GB/s/link ICI.
    hbm_bw = 819e9
    peak_bf16 = 197e12
    # The VPU (8x128 vector unit) peak is ~2 orders below the MXU; it wins
    # only for skinny-M shapes where MXU padding burns >98% of the array.
    vpu_flops = 4e12
    levels = (
        HardwareLevel(
            depth=0,
            name="mxu",
            # 4 MXUs per TensorCore issue in lockstep; model them as one
            # level-0 unit with the combined peak (the candidate generator
            # works in units of the native tile, not individual MXUs).
            parallel_units=1,
            capacity_bytes=32 * 1024,  # VREG file per core (32 KiB)
            load_bandwidth=2.6e13,  # VMEM->VREG streaming bandwidth
            compute_flops=peak_bf16,
        ),
        HardwareLevel(
            depth=1,
            name="vmem",
            parallel_units=1,
            # 128 MiB VMEM per v5e core; leave headroom for the compiler's
            # own scratch: strategies may claim at most half.
            capacity_bytes=64 * 1024 * 1024,
            load_bandwidth=hbm_bw,
            compute_flops=0.0,
        ),
        HardwareLevel(
            depth=2,
            name="grid",
            parallel_units=1,  # TensorCores per chip (v5e: 1)
            capacity_bytes=None,
            load_bandwidth=hbm_bw,
            compute_flops=0.0,
        ),
    )
    return HardwareSpec(
        name="tpu_v5e",
        levels=levels,
        native_tile={
            # MXU: contracting/output lane dims in multiples of 128; the
            # sublane dim in multiples of 16 for bf16 (8 for f32).
            "mxu": (16, 128, 128),
            # VPU path: elementwise/outer-product style — sublane 8, lane 128,
            # no systolic contraction granularity.
            "vpu": (8, 128, 8),
        },
        backends={"mxu": peak_bf16, "vpu": vpu_flops},
        link_bandwidth=50e9,
    )


def _host_cpu() -> HardwareSpec:
    """Generic host-CPU spec (empirical-profiler backend in this container).

    Mirrors the paper's Intel CPU target structurally: L0 = SIMD registers,
    L1 = per-core cache ("CacheBuffer"), L2 = multi-core process level.
    Constants are deliberately conservative; the empirical profiler corrects
    level-0 costs with real wall-clock measurements (§5.2).
    """
    levels = (
        HardwareLevel(
            depth=0,
            name="simd",
            parallel_units=1,
            capacity_bytes=2 * 1024,
            load_bandwidth=2e11,
            compute_flops=5e10,
        ),
        HardwareLevel(
            depth=1,
            name="cache",
            parallel_units=1,
            capacity_bytes=1 * 1024 * 1024,
            load_bandwidth=3e10,
            compute_flops=0.0,
        ),
        HardwareLevel(
            depth=2,
            name="cores",
            parallel_units=1,
            capacity_bytes=None,
            load_bandwidth=3e10,
            compute_flops=0.0,
        ),
    )
    return HardwareSpec(
        name="host_cpu",
        levels=levels,
        native_tile={"simd": (1, 16, 1)},
        backends={"simd": 5e10},
        link_bandwidth=1e10,
    )


def _h100_sxm() -> HardwareSpec:
    """NVIDIA H100 SXM5 (Hopper, sm_90).

    Constants: NVIDIA H100 Tensor Core GPU data sheet (SXM5: 132 SMs,
    989 TFLOP/s dense bf16 tensor core, 67 TFLOP/s FP32 on the CUDA cores,
    3.35 TB/s HBM3, 900 GB/s NVLink, 1980 MHz max boost) and the Hopper
    tuning guide / CUDA programming guide (65,536 32-bit registers and
    256 KB of combined L1/shared memory per SM, at most 227 KB = 232,448
    bytes of shared memory per block, opted in through
    cudaFuncAttributeMaxDynamicSharedMemorySize).  The tensor-core native
    tile is the PTX ISA's wgmma shape for bf16: m64 x nN x k16 with N a
    multiple of 8; the CUDA-core tile is one FMA per lane of a 32-thread
    warp along n.
    """
    hbm_bw = 3.35e12
    tensor_bf16 = 989e12
    cuda_fp32 = 67e12
    sm_count = 132
    levels = (
        HardwareLevel(
            depth=0,
            name="wgmma",
            parallel_units=1,
            # The SM's register file: 65,536 x 4 bytes.
            capacity_bytes=65536 * 4,
            # Shared memory -> registers: 128 bytes/clock/SM at the 1980 MHz
            # boost clock, over all 132 SMs.
            load_bandwidth=128 * 1.98e9 * sm_count,
            compute_flops=tensor_bf16,
        ),
        HardwareLevel(
            depth=1,
            name="smem",
            parallel_units=1,
            capacity_bytes=232448,  # 227 KB: the per-block shared-memory cap
            load_bandwidth=hbm_bw,
            compute_flops=0.0,
        ),
        HardwareLevel(
            depth=2,
            name="grid",
            parallel_units=sm_count,
            capacity_bytes=None,
            load_bandwidth=hbm_bw,
            compute_flops=0.0,
        ),
    )
    return HardwareSpec(
        name="h100_sxm",
        levels=levels,
        native_tile={
            "tensor_core": (64, 8, 16),  # wgmma m64nNk16, bf16
            "cuda_core": (1, 32, 1),     # one FMA per lane of a warp
        },
        backends={"tensor_core": tensor_bf16, "cuda_core": cuda_fp32},
        link_bandwidth=900e9,
    )


TPU_V5E: HardwareSpec = _tpu_v5e()
HOST_CPU: HardwareSpec = _host_cpu()
H100_SXM: HardwareSpec = _h100_sxm()

_REGISTRY: dict[str, HardwareSpec] = {
    s.name: s for s in (TPU_V5E, HOST_CPU, H100_SXM)
}


def get_hardware(name: str) -> HardwareSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware {name!r}; known: {sorted(_REGISTRY)}"
        ) from None
