"""Hand-written Hopper kernels and their plain PyTorch versions.

``launch_counts()`` reads every kernel's launch counter and
``reset_launch_counts()`` zeroes them, so a run can show that its path
went through the kernels.
"""
from __future__ import annotations

from repro_torch.kernels import attention, gemm

__all__ = ["launch_counts", "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    return {**gemm.LAUNCHES, **attention.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (gemm.LAUNCHES, attention.LAUNCHES):
        for name in counts:
            counts[name] = 0
