"""Ragged grouped GEMM: the wrapper of ``csrc/grouped_gemm.cu``.

Replaces the Pallas TPU kernel ``vortex_grouped_gemm`` (src/repro/kernels/
grouped_gemm.py, body ``_grouped_gemm_kernel``).  out[g] = x[g] @ w[g // r]
for x ``(G, C, K)`` capacity-shaped activation slabs and w ``(E, K, N)``
stacked expert weights (``r = G // E`` consecutive groups per expert), with
an f32 accumulator.  ``counts`` ``(G,)`` holds each group's true row
count: rows at or past it may hold anything (NaN included) and the
matching output rows are exactly zero.  One launch covers every group,
and the selected tile (block_m, block_n, block_k) is honoured verbatim.

Bound on the H100: the bytes of the expert weights and the output (see
the note in csrc/grouped_gemm.cu).  The kernel has the same two paths as
csrc/gemm.cu: a wgmma tile on a cp.async ring for bf16 at a
``tensor_core`` strategy, f32 FMAs on the CUDA cores otherwise.  The
tensor-core path tiles M over each expert's stacked rows: x ``(G, C, K)``
is the ``(E, r*C, K)`` tensor, so one m-tile may hold rows of several
groups of one expert and each expert's weight strip is read once for all
of them, wherever that takes fewer m-tiles (:func:`stacked_grid`).  A decode, whose every batch row is its
own one-row group, gains the most; with ``r = 1`` the launch is one
group's per m-tile, as on the CUDA-core path.  A tensor on the CPU takes
:func:`vortex_grouped_gemm_plain`; a CUDA tensor launches the kernel or
raises.  ``counts`` stays on the device: the kernel reads it there, so
the wrapper never waits for routing to finish.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.gemm import (OperandError, check_backend, kernel_path,
                                      validate_blocks)
from repro_torch.kernels.ref import ref_grouped_gemm

__all__ = [
    "vortex_grouped_gemm", "vortex_grouped_gemm_plain", "stacked_grid",
    "StackedGrid", "LAUNCHES",
]

# Launches of the CUDA kernel, counted where it is launched and nowhere
# else: the total, each path (``kernel_path``) on its own, and the
# tensor-core launches whose m-tiles stack groups (``stacked_grid``).
# chip_smoke.py zeroes them around the main path.
LAUNCHES = {
    "vortex_grouped_gemm": 0, "vortex_grouped_gemm.tensor_core": 0,
    "vortex_grouped_gemm.cuda_core": 0, "vortex_grouped_gemm.stacked": 0,
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class StackedGrid(NamedTuple):
    """The m-extent of a tensor-core launch (``m_tiles``, the grid's x) and
    whether some m-tile holds rows of more than one group (``stacked``)."""

    m_tiles: int
    stacked: bool


def stacked_grid(G: int, E: int, C: int, block_m: int) -> StackedGrid:
    """The tensor-core path's m-tiles.  Stacked, each walks one expert's
    ``r*C`` rows (``r = G // E`` groups of ``C``): ``E * cdiv(r*C, block_m)``
    of them.  A launch stacks where that is fewer than one group a tile,
    ``G * cdiv(C, block_m)``, which needs ``r > 1`` and ``C % block_m != 0``
    (a tile then holds rows of more than one group) and fails where the
    remainder of ``C`` is most of a tile (``r = 2`` and ``C % block_m >
    block_m / 2``); otherwise the launch keeps one group a tile."""
    r = G // E
    per_expert = E * -(-(r * C) // block_m)
    per_group = G * -(-C // block_m)
    return StackedGrid(min(per_expert, per_group), per_expert < per_group)


def vortex_grouped_gemm_plain(x, w, counts) -> torch.Tensor:
    """The kernel's function in plain PyTorch: rows at or past
    ``counts[g]`` are selected to zero with ``torch.where`` (the pad may
    hold NaN), then one einsum over the ``(E, r, C, K)`` reshape."""
    return ref_grouped_gemm(x, w, counts)


def vortex_grouped_gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    counts,
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
    backend: str = "cuda_core",
) -> torch.Tensor:
    """``(G, C, N)`` grouped product; the output has ``x``'s dtype.

    ``counts`` is a ``(G,)`` integer tensor (on the card: on ``x``'s
    device) or a sequence of ints.  Non-contiguous operands are made
    contiguous (a copy): the kernel walks dense row-major slabs.

    ``backend`` is the selected strategy's backend, validated with the
    tile on every device as in :func:`~repro_torch.kernels.gemm.vortex_gemm`.
    On the card the path is fixed before the launch: bf16 at
    ``tensor_core`` runs wgmma on a cp.async ring over each expert's
    stacked rows (:func:`stacked_grid`); ``cuda_core``, and float32 at
    either backend, run f32 FMAs on the CUDA cores (Hopper has no exact f32
    tensor-core product) with one group per m-tile.
    """
    G, C, K = x.shape
    E, K2, N = w.shape
    if K != K2 or E < 1 or G % E:
        raise OperandError(
            f"vortex_grouped_gemm: x {tuple(x.shape)} and w {tuple(w.shape)} "
            "need equal K and a group count that is a multiple of E"
        )
    validate_blocks(
        "vortex_grouped_gemm", block_m=block_m, block_n=block_n,
        block_k=block_k,
    )
    plan = check_backend("vortex_grouped_gemm", backend, block_m, block_n,
                         block_k)
    if x.device.type == "cpu":
        return vortex_grouped_gemm_plain(x, w, counts)
    if x.device.type != "cuda" or w.device != x.device:
        raise OperandError(
            f"vortex_grouped_gemm: operands on {x.device} and {w.device}; the "
            "kernel takes x and w on one CUDA device"
        )
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise OperandError(
            f"vortex_grouped_gemm: dtypes {x.dtype}, {w.dtype}; the kernel "
            "takes float32 or bfloat16 for both"
        )
    if -(-N // block_n) > 65535:
        raise ValueError(
            f"vortex_grouped_gemm: {-(-N // block_n)} column blocks exceed "
            "the grid's y limit of 65535"
        )
    cnt = torch.as_tensor(counts, device=x.device)
    if cnt.numel() != G or cnt.is_floating_point():
        raise OperandError(
            f"vortex_grouped_gemm: counts must hold {G} integers, got "
            f"{tuple(cnt.shape)} {cnt.dtype}"
        )
    cnt = cnt.to(torch.int32).reshape(G).contiguous()
    x, w = x.contiguous(), w.contiguous()
    from repro_torch.kernels.build import library

    lib = library()
    out = torch.empty((G, C, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    path = kernel_path(plan, x.dtype)
    if path == "tensor_core":
        rc = lib.vortex_grouped_gemm_tc_launch(
            x.data_ptr(), w.data_ptr(), cnt.data_ptr(), out.data_ptr(),
            G, E, C, N, K, block_m, block_n, block_k, plan.wm, plan.wn,
            plan.n_atom, plan.atoms, plan.stages, plan.smem_bytes, stream,
        )
    else:
        rc = lib.vortex_grouped_gemm_launch(
            x.data_ptr(), w.data_ptr(), cnt.data_ptr(), out.data_ptr(),
            G, E, C, N, K, block_m, block_n, block_k, _DTYPE_CODE[x.dtype],
            stream,
        )
    if rc:
        raise RuntimeError(
            f"vortex_grouped_gemm: {path} kernel launch failed (cudaError {rc})"
        )
    LAUNCHES["vortex_grouped_gemm"] += 1
    LAUNCHES[f"vortex_grouped_gemm.{path}"] += 1
    if path == "tensor_core" and stacked_grid(G, E, C, block_m).stacked:
        LAUNCHES["vortex_grouped_gemm.stacked"] += 1
    return out
