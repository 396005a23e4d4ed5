"""Direct wrappers over the hand-written kernels, with no engine
(counterpart of src/repro/kernels/ops.py).

The reference's ``interpret`` flag has no counterpart: the operands'
device decides.  On the card each call launches its kernel (``matmul``:
``csrc/gemm.cu``; ``attention``: ``csrc/attention*.cu``; ``conv2d``:
im2col and the GEMM kernel) and counts its launch; a build or launch
error raises, and nothing falls back to a plain version.  On the CPU
each runs its kernel's plain version.  The block defaults are the
reference's; ``backend`` picks the kernel's path as in the wrappers it
calls (``tensor_core`` runs the wgmma kernels on bf16 operands).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.conv import vortex_conv2d
from repro_torch.kernels.gemm import vortex_gemm

__all__ = ["matmul", "attention", "conv2d", "on_cuda"]


def on_cuda() -> bool:
    """Whether a card is present (the reference's ``on_tpu``)."""
    return torch.cuda.is_available()


def matmul(
    a, b, m_true=None, *, block_m=128, block_n=128, block_k=128,
    backend="cuda_core",
):
    return vortex_gemm(
        a, b, m_true, block_m=block_m, block_n=block_n, block_k=block_k,
        backend=backend,
    )


def attention(
    q, k, v, kv_len=None, *, block_q=128, block_k=128, causal=True,
    window=None, softcap=None, backend="cuda_core",
):
    """``block_q=1`` with one query row runs the split-kv decode kernel."""
    return flash_attention(
        q, k, v, kv_len, block_q=block_q, block_k=block_k, causal=causal,
        window=window, softcap=softcap, backend=backend,
    )


def conv2d(x, w, *, stride=1, block_m=128, block_n=128, block_k=128,
           backend="cuda_core"):
    return vortex_conv2d(
        x, w, stride=stride, block_m=block_m, block_n=block_n,
        block_k=block_k, backend=backend,
    )
