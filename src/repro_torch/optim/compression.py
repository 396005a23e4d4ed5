"""Error-feedback int8 gradient compression (counterpart of
src/repro/optim/compression.py): a per-tensor symmetric int8 code whose
quantization residual is carried into the next step's gradient.  The
reference applies it to the cross-pod hop of its sharded step; here the
functions stand alone until the mesh is ported."""
from __future__ import annotations

import torch

__all__ = ["compress_int8", "decompress_int8", "ef_compress_update"]


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization: ``(q, scale)``."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_update(
    grad: torch.Tensor, error: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback compression of one gradient tensor: ``(q, scale,
    new_error, compressed_grad)`` with ``compressed_grad = dequant(q,
    scale)`` and ``new_error = (grad + error) - compressed_grad``."""
    target = grad.float() + error
    q, scale = compress_int8(target)
    approx = decompress_int8(q, scale)
    return q, scale, target - approx, approx
