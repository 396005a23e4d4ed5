"""Convolution through im2col and the Vortex GEMM kernel.

Counterpart of src/repro/kernels/conv.py.  im2col turns a VALID Conv2D into
a GEMM with M = b*h'*w' (dynamic), N = cout and K = kh*kw*cin, which the
hand-written ``vortex_gemm`` (csrc/gemm.cu) serves with the tile the
lattice selected; the kernel masks its own tails, so no dim is rounded up.
The patch matrix is one strided view of the NHWC input, (b, h', w', cin,
kh, kw), copied dense in a single pass; its feature order (cin, kh, kw) is
that of the reference's ``conv_general_dilated_patches``, and the weights
are transposed to match.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gemm import vortex_gemm

__all__ = ["im2col", "conv_weight_matrix", "vortex_conv2d"]


def im2col(
    x: torch.Tensor, kh: int, kw: int, stride: int = 1
) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """(b, h, w, cin) -> a contiguous (b*h'*w', cin*kh*kw) patch matrix,
    VALID padding, features ordered (cin, kh, kw); and (b, h', w')."""
    b, h, w, cin = x.shape
    ho = (h - kh) // stride + 1
    wo = (w - kw) // stride + 1
    x = x.contiguous()
    sb, sh, sw, sc = x.stride()
    # patches[i, p, q, c, u, v] = x[i, p*stride + u, q*stride + v, c]
    patches = x.as_strided(
        (b, ho, wo, cin, kh, kw), (sb, stride * sh, stride * sw, sc, sh, sw),
        x.storage_offset(),
    )
    # One dense copy, so the GEMM kernel gets a dense operand whatever b is.
    cols = patches.reshape(b * ho * wo, cin * kh * kw).contiguous()
    return cols, (b, ho, wo)


def conv_weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """(kh, kw, cin, cout) -> the (cin*kh*kw, cout) GEMM operand in
    im2col's (cin, kh, kw) feature order."""
    kh, kw, cin, cout = w.shape
    return w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout).contiguous()


def vortex_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
    backend: str = "cuda_core",
) -> torch.Tensor:
    """Conv2D (VALID) through im2col and the masked-tail GEMM kernel:
    x (b, h, w, cin), w (kh, kw, cin, cout) -> (b, h', w', cout).
    ``backend`` picks the GEMM's path as in ``vortex_gemm``."""
    cols, (b, ho, wo) = im2col(x, w.shape[0], w.shape[1], stride)
    out = vortex_gemm(
        cols, conv_weight_matrix(w), block_m=block_m, block_n=block_n,
        block_k=block_k, backend=backend,
    )
    return out.reshape(b, ho, wo, w.shape[3])
