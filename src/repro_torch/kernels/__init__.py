"""Hand-written Hopper kernels and their plain PyTorch versions.

``launch_counts()`` reads every kernel's launch counter and
``reset_launch_counts()`` zeroes them, so a run can show that its path
went through the kernels.
"""
from __future__ import annotations

from repro_torch.kernels import attention, gemm, grouped_gemm

__all__ = ["launch_counts", "reset_launch_counts"]

_COUNTERS = (gemm.LAUNCHES, attention.LAUNCHES, grouped_gemm.LAUNCHES)


def launch_counts() -> dict[str, int]:
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0
