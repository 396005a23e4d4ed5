"""Where the port runs: the card unless the caller asks for the CPU.

Every entry point resolves its ``device``/``impl`` pair here, so a machine
without a GPU raises instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "resolve_impl"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and no GPU
    is present (pass ``device="cpu"`` to run the plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and torch.cuda is not "
            "available here; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def resolve_impl(device: torch.device, impl: str | None) -> str:
    """The executable implementation for ``device``: ``"cuda"`` (the
    hand-written kernels) on the card, ``"torch"`` (their plain versions)
    on the CPU.  ``impl="torch"`` on the card is allowed (the reference
    lowering); ``impl="cuda"`` on the CPU is refused."""
    if impl is None:
        return "cuda" if device.type == "cuda" else "torch"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError("impl='cuda' needs device='cuda'")
    return impl
