"""Vortex-tiled masked-tail GEMM: the wrapper of ``csrc/gemm.cu``.

Replaces the Pallas TPU kernel ``vortex_gemm`` (src/repro/kernels/gemm.py,
body ``_gemm_kernel``).  C[M, N] = A[M, K] @ B[K, N] with an f32
accumulator, rows at or past the runtime ``m_true`` read as zero (the pad
tail may hold NaN), K/N tails masked, and the selected tile
(block_m, block_n, block_k) honoured verbatim.

Bound on the H100: compute (tensor-core rate) at the served shapes; the
kernel runs its FMAs on the CUDA cores through a shared-memory staged,
register-tiled loop (see the note in csrc/gemm.cu).  A tensor on the CPU
takes :func:`vortex_gemm_plain`; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import ref_gemm

__all__ = [
    "vortex_gemm", "vortex_gemm_plain", "validate_blocks", "gemm_smem_bytes",
    "LAUNCHES",
]

# Launches of the CUDA kernel, counted where it is launched and nowhere
# else; chip_smoke.py zeroes it around the main path.
LAUNCHES = {"vortex_gemm": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def validate_blocks(kind: str, **blocks: int) -> None:
    """Reject block sizes the kernel could not honour (never clamp)."""
    for name, blk in blocks.items():
        if not isinstance(blk, int) or isinstance(blk, bool) or blk < 1:
            raise ValueError(
                f"{kind}: {name}={blk!r} cannot be honored — selected tiles "
                "must be positive integers (the kernel masks tails instead "
                "of clamping, so a degenerate block has no meaning)"
            )


def gemm_smem_bytes(block_m: int, block_n: int, block_k: int) -> int:
    """Shared memory one block of csrc/gemm.cu uses (mirrors its launch)."""
    return min(block_k, 16) * (min(block_m, 64) + min(block_n, 64)) * 4


def vortex_gemm_plain(a, b, m_true=None, out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: rows at or past ``m_true``
    are selected to zero (not multiplied by zero) before the product."""
    M = a.shape[0]
    if m_true is not None and m_true < M:
        rows = torch.arange(M, device=a.device) < m_true
        a = torch.where(rows[:, None], a, 0.0)
    return ref_gemm(a, b, out_dtype)


def vortex_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    m_true: int | None = None,
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
    out_dtype=None,
) -> torch.Tensor:
    """C = A @ B with the Vortex layer-1 tile as the launch geometry.

    ``m_true`` (a Python int) is the number of real leading rows of ``a``;
    the rest of ``a`` is never read.  The output has ``a``'s dtype.
    """
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"vortex_gemm: inner dims differ: {a.shape} @ {b.shape}")
    validate_blocks(
        "vortex_gemm", block_m=block_m, block_n=block_n, block_k=block_k
    )
    m_true = M if m_true is None else int(m_true)
    if a.device.type == "cpu":
        return vortex_gemm_plain(a, b, m_true, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"vortex_gemm: operands on {a.device} and {b.device}; the kernel "
            "takes two tensors on one CUDA device"
        )
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"vortex_gemm: dtypes {a.dtype}, {b.dtype}; the kernel takes "
            "float32 or bfloat16 for both"
        )
    if out_dtype is not None and out_dtype != a.dtype:
        raise TypeError("vortex_gemm: the kernel writes the operands' dtype")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("vortex_gemm: operands must be contiguous")
    if -(-M // block_m) > 65535:
        raise ValueError(
            f"vortex_gemm: {-(-M // block_m)} row blocks exceed the grid's "
            "y limit of 65535"
        )
    from repro_torch.kernels.build import library

    lib = library()
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    rc = lib.vortex_gemm_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
        max(0, min(m_true, M)), block_m, block_n, block_k,
        _DTYPE_CODE[a.dtype], torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"vortex_gemm: kernel launch failed (cudaError {rc})")
    LAUNCHES["vortex_gemm"] += 1
    return out
