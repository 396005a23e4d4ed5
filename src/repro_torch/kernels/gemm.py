"""Vortex-tiled masked-tail GEMM: the wrapper of ``csrc/gemm.cu``.

Replaces the Pallas TPU kernel ``vortex_gemm`` (src/repro/kernels/gemm.py,
body ``_gemm_kernel``).  C[M, N] = A[M, K] @ B[K, N] with an f32
accumulator, rows at or past the runtime ``m_true`` read as zero (the pad
tail may hold NaN), K/N tails masked, and the selected tile
(block_m, block_n, block_k) honoured verbatim.

Bound on the H100: the bytes moved or the tensor-core rate at the served
shapes; at the tall tiles the lattice serves (512, 32, 64), the L2 reads of
A (about 30 FLOP a byte).  The kernel has one path per backend of the H100
lattice (see the notes in csrc/gemm.cu, csrc/tc_tma.cuh and
csrc/tc_tile.cuh): ``tensor_core``, a wgmma tile whose warpgroups
:func:`tensor_core_plan` lays out, fed by a TMA producer warp through an
mbarrier ring that :func:`tma_plan` sizes (A multicast across a 2-CTA
cluster at tall tiles), or on a cp.async ring for operands TMA cannot
address; and ``cuda_core``, f32 FMAs through a shared-memory staged,
register-tiled loop.  A tensor on the CPU takes :func:`vortex_gemm_plain`;
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ref import ref_gemm

__all__ = [
    "vortex_gemm", "vortex_gemm_plain", "validate_blocks", "gemm_smem_bytes",
    "BACKENDS", "TensorCorePlan", "tensor_core_plan", "check_backend",
    "TmaPlan", "tma_plan", "kernel_path", "LAUNCHES",
]

# Launches of the CUDA kernel, counted where it is launched and nowhere
# else: the total, and each path (``kernel_path``) on its own; within
# ``tensor_core``, the TMA kernel and the cp.async one (the two sum to it),
# and the TMA launches made as 2-CTA clusters (``multicast``).
# chip_smoke.py zeroes them around the main path.
LAUNCHES = {
    "vortex_gemm": 0, "vortex_gemm.tensor_core": 0, "vortex_gemm.cuda_core": 0,
    "vortex_gemm.tensor_core.tma": 0, "vortex_gemm.tensor_core.cp_async": 0,
    "vortex_gemm.tensor_core.multicast": 0,
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The H100 lattice's backends (core/hardware.py H100_SXM).
BACKENDS = ("tensor_core", "cuda_core")
TENSOR_CORE_ATOM = (64, 8, 16)  # wgmma m64nNk16, bf16
SMEM_PER_BLOCK = 232448  # the most shared memory one block may use
_MAX_STAGES = 4
# (atom width, atoms per warpgroup) pairs built in csrc/wgmma.cuh: at most
# 64 f32 accumulators a thread.
_TC_VARIANTS = frozenset({
    (8, 1), (8, 2), (8, 4), (8, 8), (16, 1), (16, 2), (16, 4), (16, 8),
    (32, 1), (32, 2), (32, 4), (64, 1), (64, 2), (128, 1),
})


class OperandError(ValueError, TypeError):
    """A wrapper refuses the operands themselves -- a shape, stride, dtype
    or device its kernel does not take -- whatever the tile.  Such a call
    fails alike on every candidate, so the engine's degradation ladder
    lets it through with nothing quarantined (core/engine.py).  It is a
    ``ValueError`` and a ``TypeError``, as the wrappers' checks were."""


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
    """Shared memory one block of csrc/gemm.cu's CUDA-core path uses
    (mirrors its launch)."""
    return min(block_k, 16) * (min(block_m, 64) + min(block_n, 64)) * 4


class TensorCorePlan(NamedTuple):
    """How csrc/tc_tile.cuh runs one (block_m, block_n, block_k) tile: a
    ``wm`` x ``wn`` grid of warpgroups, each owning ``atoms`` 64 x
    ``n_atom`` wgmma accumulators, over a ring of ``stages`` k-steps in
    ``smem_bytes`` of shared memory."""

    wm: int
    wn: int
    n_atom: int
    atoms: int
    stages: int
    smem_bytes: int

    @property
    def warpgroups(self) -> int:
        return self.wm * self.wn

    @property
    def threads(self) -> int:
        return 128 * self.warpgroups

    @property
    def acc_per_thread(self) -> int:
        """f32 accumulator registers a thread holds."""
        return self.atoms * self.n_atom // 2


def tensor_core_plan(block_m: int, block_n: int, block_k: int) -> TensorCorePlan:
    """The launch plan of the tensor-core path for a tile, or ValueError
    when the path cannot honour the tile (it is never clamped).

    Warpgroups split the tile's 64-row atoms first (up to 4), then its
    columns into slices of at least 64; each warpgroup's slice is cut into
    atoms of the widest power of two up to 128 that divides it.  The ring
    holds as many k-steps (2 to 4) as stay within the tile's priced
    footprint, ``l1_tile_bytes`` = 2 stages + the f32 accumulator
    (core/workloads.py); the epilogue stages the bf16 tile, rows padded by
    8, in the same shared memory.
    """
    am, an, ak = TENSOR_CORE_ATOM
    if block_m % am or block_n % an or block_k % ak:
        raise ValueError(
            f"tensor_core tile ({block_m}, {block_n}, {block_k}) is not a "
            f"multiple of the wgmma atom {TENSOR_CORE_ATOM}"
        )
    m_atoms = block_m // am
    wm = max(d for d in (4, 3, 2, 1) if m_atoms % d == 0)
    wn = 1
    while wm * wn * 2 <= 4 and block_n % (wn * 2 * 64) == 0:
        wn *= 2
    cols = block_n // wn
    n_atom = max(w for w in (128, 64, 32, 16, 8) if cols % w == 0)
    atoms = (m_atoms // wm) * (cols // n_atom)
    if (n_atom, atoms) not in _TC_VARIANTS:
        raise ValueError(
            f"tensor_core tile ({block_m}, {block_n}, {block_k}) needs "
            f"{atoms} accumulators of 64 x {n_atom} a warpgroup; the kernel "
            f"is built for {sorted(_TC_VARIANTS)}"
        )
    stage = 2 * (block_m * block_k + block_k * block_n)
    budget = min(2 * stage + 4 * block_m * block_n, SMEM_PER_BLOCK)
    stages = 2
    while stages < _MAX_STAGES and (stages + 1) * stage <= budget:
        stages += 1
    smem = max(stages * stage, 2 * block_m * (block_n + 8))
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"tensor_core tile ({block_m}, {block_n}, {block_k}) needs {smem} "
            f"bytes of shared memory; a block has {SMEM_PER_BLOCK}"
        )
    return TensorCorePlan(wm, wn, n_atom, atoms, stages, smem)


def check_backend(
    kind: str, backend: str, block_m: int, block_n: int, block_k: int
) -> TensorCorePlan | None:
    """Validate the (backend, tile) pair: the tensor-core plan, or None for
    ``cuda_core`` (whose FMA loop takes any positive tile)."""
    if backend not in BACKENDS:
        raise ValueError(
            f"{kind}: unknown backend {backend!r}; the kernels serve {BACKENDS}"
        )
    if backend == "cuda_core":
        return None
    try:
        return tensor_core_plan(block_m, block_n, block_k)
    except ValueError as e:
        raise ValueError(f"{kind}: {e}") from None


class TmaPlan(NamedTuple):
    """How csrc/tc_tma.cuh feeds one tile: a ring of ``stages`` k-steps in
    ``smem_bytes`` of shared memory, A loaded in boxes of ``box_m`` rows and
    shared by ``cluster`` CTAs along N (1, or 2 to multicast A)."""

    stages: int
    cluster: int
    box_m: int
    smem_bytes: int


_TMA_ALIGN = 1024  # a 128-byte swizzle repeats every 8 rows of 128 bytes
_TMA_BOX_MAX = 256  # TMA's largest box edge
_TMA_A_BOX = (16, 32, 64)  # box rows of 32-, 64- and 128-byte swizzle
_TMA_B_BOX = (8, 16, 32, 64)  # and of 16 bytes, unswizzled


def _tma_smem_bytes(block_m: int, block_n: int, block_k: int,
                    stages: int) -> int:
    """Shared memory of csrc/tc_tma.cuh at ``stages`` slots (mirrors its
    ``smem_bytes``): alignment slack, the ring or the epilogue's staged
    tile, whichever is larger, and two mbarriers a slot."""
    stage = -(-2 * (block_m * block_k + block_k * block_n)
              // _TMA_ALIGN) * _TMA_ALIGN
    return _TMA_ALIGN + max(stages * stage, 2 * block_m * (block_n + 8)) \
        + 16 * stages


def tma_plan(block_m: int, block_n: int, block_k: int, N: int, K: int, *,
             aligned: bool = True, multicast: bool = True) -> TmaPlan | None:
    """The TMA kernel's plan for a tensor-core tile (one that
    :func:`tensor_core_plan` accepts) at (N, K), or None when TMA cannot
    address the operands and the cp.async kernel runs instead.

    None when a row of A or B is not a whole number of 16-byte words (K or
    N not a multiple of 8), when ``aligned`` is False (an operand's pointer
    off 16 bytes), or when the tile's boxes fit no layout wgmma reads: A's
    box is min(block_k, 64) columns, 16, 32 or 64 (32-, 64-, 128-byte
    swizzled rows), B's min(block_n, 64), the same or 8 (16-byte rows,
    unswizzled), each dividing its side of the tile, and B's box rows
    min(block_k, 256) divide block_k.  The ring holds as many
    k-steps as fit in a block's shared memory (at least 2, else None).
    A tall tile (block_m >= 4 block_n) whose N tiles pair up launches
    clusters of 2 CTAs along N that share A (``multicast=False``: never);
    A's boxes are the largest multiple of 8 rows, at most 256, that divides
    block_m -- at most half of it in a cluster, so both CTAs load a box.
    """
    if not aligned or K % 8 or N % 8:
        return None
    a_k, b_n = min(block_k, 64), min(block_n, 64)
    if (a_k not in _TMA_A_BOX or block_k % a_k or b_n not in _TMA_B_BOX
            or block_n % b_n or block_k % min(block_k, _TMA_BOX_MAX)):
        return None
    tall = block_m >= 4 * block_n and (-(-N // block_n)) % 2 == 0
    cluster = 2 if multicast and tall else 1
    box_m = max(d for d in range(8, min(_TMA_BOX_MAX, block_m // cluster) + 1,
                                 8) if block_m % d == 0)
    stages = 1
    while _tma_smem_bytes(block_m, block_n, block_k,
                          stages + 1) <= SMEM_PER_BLOCK:
        stages += 1
    if stages < 2:
        return None
    return TmaPlan(stages, cluster, box_m,
                   _tma_smem_bytes(block_m, block_n, block_k, stages))


def kernel_path(plan: TensorCorePlan | None, dtype: torch.dtype) -> str:
    """The path a launch takes, fixed before it from the backend and dtype:
    bf16 at a ``tensor_core`` strategy runs the wgmma tile; a ``cuda_core``
    strategy, and float32 at either backend, run the FMA loop (Hopper has no
    exact f32 tensor-core product: TF32 keeps about 3 digits)."""
    return "tensor_core" if plan is not None and dtype == torch.bfloat16 \
        else "cuda_core"


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
    backend: str = "cuda_core",
    out_dtype=None,
    tma: bool = True,
    multicast: bool = True,
) -> torch.Tensor:
    """C = A @ B with the Vortex layer-1 tile as the launch geometry.

    ``m_true`` (a Python int) is the number of real leading rows of ``a``;
    the rest of ``a`` is never read.  The output has ``a``'s dtype.

    ``backend`` is the selected strategy's backend.  The (backend, tile)
    pair is validated first, on every device: an unknown backend, or a
    ``tensor_core`` tile that is not a multiple of (64, 8, 16) or that the
    wgmma tile cannot hold, raises ``ValueError``.  On the card the path is
    fixed before the launch (:func:`kernel_path`): bf16 at ``tensor_core``
    runs wgmma fed by TMA (:func:`tma_plan`), or on a cp.async ring where
    TMA cannot address the operands; ``cuda_core``, and float32 at either
    backend, run f32 FMAs on the CUDA cores.  ``tma=False`` takes the
    cp.async kernel and ``multicast=False`` keeps every cluster at one CTA,
    so the kernels can be timed against each other.
    """
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise OperandError(
            f"vortex_gemm: inner dims differ: {a.shape} @ {b.shape}")
    validate_blocks(
        "vortex_gemm", block_m=block_m, block_n=block_n, block_k=block_k
    )
    plan = check_backend("vortex_gemm", backend, block_m, block_n, block_k)
    m_true = M if m_true is None else int(m_true)
    if a.device.type == "cpu":
        return vortex_gemm_plain(a, b, m_true, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise OperandError(
            f"vortex_gemm: operands on {a.device} and {b.device}; the kernel "
            "takes two tensors on one CUDA device"
        )
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise OperandError(
            f"vortex_gemm: dtypes {a.dtype}, {b.dtype}; the kernel takes "
            "float32 or bfloat16 for both"
        )
    if out_dtype is not None and out_dtype != a.dtype:
        raise OperandError(
            "vortex_gemm: the kernel writes the operands' dtype")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise OperandError("vortex_gemm: operands must be contiguous")
    path = kernel_path(plan, a.dtype)
    # grid y: column blocks on the tensor-core path, row blocks on the other.
    y_blocks = -(-N // block_n) if path == "tensor_core" else -(-M // block_m)
    if y_blocks > 65535:
        raise ValueError(
            f"vortex_gemm: {y_blocks} blocks exceed the grid's y limit of 65535"
        )
    from repro_torch.kernels.build import library

    lib = library()
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    m_live = max(0, min(m_true, M))
    feed = None
    if path == "tensor_core":
        feed = tma_plan(
            block_m, block_n, block_k, N, K,
            aligned=tma and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0,
            multicast=multicast,
        )
    if feed is not None:
        rc = lib.vortex_gemm_tma_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, m_live,
            block_m, block_n, block_k, plan.wm, plan.wn, plan.n_atom,
            plan.atoms, feed.stages, feed.cluster, feed.box_m,
            feed.smem_bytes, stream,
        )
    elif path == "tensor_core":
        rc = lib.vortex_gemm_tc_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, m_live,
            block_m, block_n, block_k, plan.wm, plan.wn, plan.n_atom,
            plan.atoms, plan.stages, plan.smem_bytes, stream,
        )
    else:
        rc = lib.vortex_gemm_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, m_live,
            block_m, block_n, block_k, _DTYPE_CODE[a.dtype], stream,
        )
    if rc:
        raise RuntimeError(
            f"vortex_gemm: {path} kernel launch failed (cudaError {rc})"
        )
    LAUNCHES["vortex_gemm"] += 1
    LAUNCHES[f"vortex_gemm.{path}"] += 1
    if path == "tensor_core":
        LAUNCHES["vortex_gemm.tensor_core."
                 + ("cp_async" if feed is None else "tma")] += 1
        if feed is not None and feed.cluster > 1:
            LAUNCHES["vortex_gemm.tensor_core.multicast"] += 1
    return out
