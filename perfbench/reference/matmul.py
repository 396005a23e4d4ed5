"""Plain float32 matmul of the stream's operands, and its control: the
same product of the operands rounded to float8 e4m3 under per-tensor
scales."""
from __future__ import annotations

import torch

from reference.decoder import _q


@torch.no_grad()
def matmul(a: torch.Tensor, b: torch.Tensor, fmt: str = "f32") -> torch.Tensor:
    return _q(a, fmt) @ _q(b, fmt)
