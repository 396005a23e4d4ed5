"""Hand-written Hopper kernels and their plain PyTorch versions.

``launch_counts()`` reads every kernel's launch counter and
``reset_launch_counts()`` zeroes them, so a run can show that its path
went through the kernels.  ``add_launch_counts(delta)`` adds a recorded
delta: a CUDA graph's replay launches the kernels it captured without
running their wrappers, so the replaying caller adds the launches the
capture counted.
"""
from __future__ import annotations

from repro_torch.kernels import attention, gemm, grouped_gemm, stage

__all__ = ["launch_counts", "reset_launch_counts", "add_launch_counts"]

_COUNTERS = (gemm.LAUNCHES, attention.LAUNCHES, grouped_gemm.LAUNCHES,
             stage.LAUNCHES)


def launch_counts() -> dict[str, int]:
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (counter name -> launches, as two ``launch_counts()``
    readings differ) to the counters."""
    for counts in _COUNTERS:
        for name in counts:
            counts[name] += delta.get(name, 0)
