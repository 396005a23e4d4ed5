"""Workload protocol + registry: the workload-generic face of the pipeline.

The paper's central claim (§4) is that ONE hardware-hierarchized strategy
space serves *all* dynamic-shape tensor programs.  This module is where a
tensor program declares everything the pipeline needs to know about it:

  * its axes and which of them are dynamic (unknown until runtime),
  * its rKernel program (rkernel.py metadata, per hardware level),
  * its per-tile footprint / FLOP / traffic model (consumed by the candidate
    generator's ``InitCands`` capacity checks and by the Eq. 2-4 cost model),
  * how a runtime shape maps onto the (m, n, k) contraction view, and
  * a kernel builder that turns a runtime :class:`Selection` into an
    executable (the hand-written CUDA kernel or its plain PyTorch version).

The registered workloads of this slice:

  * :class:`GemmWorkload`        — C[M,N] = A[M,K] @ B[K,N], dynamic M,
  * :class:`AttentionWorkload`   — flash attention, dynamic sequence length
    (the l1 m-tile is the query block, the l1 k-tile the key/value block),
  * :class:`DecodeAttentionWorkload` — single-token decode against a
    kv-bucketed cache (shares the attention lattice),
  * :class:`GroupedGemmWorkload` — the MoE expert FFN: G ragged GEMMs in
    one launch, dynamic capacity C (shares the gemm lattice),
  * :class:`Conv2dWorkload`      — VALID Conv2D as an im2col GEMM, dynamic
    M = b*h'*w' (its ``stage_view`` is the im2col).

The pricing half (lattice, footprints, traffic, buckets) is the JAX
package's field for field; the execution half speaks PyTorch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Mapping

import torch

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.rkernel import (
    AnalyzeType,
    LayerMetaInfo,
    LoopType,
    RKernelProgram,
)

__all__ = [
    "Workload",
    "GemmWorkload",
    "AttentionWorkload",
    "DecodeAttentionWorkload",
    "GroupedGemmWorkload",
    "Conv2dWorkload",
    "SelectionDeviationError",
    "WORKLOADS",
    "register_workload",
    "make_workload",
]

Tile = tuple[int, int, int]

# kind -> workload class; the single registry the engine serves from.
WORKLOADS: dict[str, type["Workload"]] = {}


def register_workload(cls: type["Workload"]) -> type["Workload"]:
    """Class decorator: expose a workload to the engine by its ``kind``."""
    if not cls.kind:
        raise ValueError(f"{cls.__name__} must set a non-empty `kind`")
    WORKLOADS[cls.kind] = cls
    return cls


def make_workload(kind: str, **kwargs: Any) -> "Workload":
    try:
        cls = WORKLOADS[kind]
    except KeyError:
        raise KeyError(
            f"unknown workload {kind!r}; registered: {sorted(WORKLOADS)}"
        ) from None
    return cls(**kwargs)


def _make_program(
    hw: HardwareSpec, kind: str, funcs: Mapping[int, tuple[str, str, str]]
) -> RKernelProgram:
    """Shared rKernel skeleton (paper Fig. 10): PL loops at the top level,
    TSL below, TRL on k everywhere; empirical analyzer only at level 0."""
    layers = []
    for depth in range(hw.num_levels):
        load, store, compute = funcs.get(depth, ("", "", ""))
        layers.append(
            LayerMetaInfo(
                layer_depth=depth,
                loop_type={
                    "m": LoopType.PARALLEL if depth == hw.num_levels - 1
                    else LoopType.TEMPORAL_SPATIAL,
                    "n": LoopType.PARALLEL if depth == hw.num_levels - 1
                    else LoopType.TEMPORAL_SPATIAL,
                    "k": LoopType.TEMPORAL_REDUCTION,
                },
                analyzer=AnalyzeType.EMPIRICAL if depth == 0
                else AnalyzeType.ANALYTICAL,
                load_func=load,
                store_func=store,
                compute_func=compute,
            )
        )
    return RKernelProgram(kind=kind, layers=tuple(layers), hardware=hw.name)


class SelectionDeviationError(RuntimeError):
    """An executable would have to deviate from its Selection to run.

    The masked-tail kernels honor the selected layer-1 tile verbatim (tails
    are masked in-kernel, never clamped), so the only way a Selection can
    fail to be honored is an internal inconsistency — e.g. a bucket that is
    not a multiple of its own tile.  Raising beats silently running a tile
    the cost model never priced.
    """


def _check_bucket_tiles(kind: str, sel, pairs) -> None:
    """Every (bucket extent, tile) pair must divide exactly — the staged
    buffers are bucket-shaped, so a non-dividing tile would force the grid
    to deviate from the priced launch geometry."""
    for name, extent, tile in pairs:
        if tile < 1 or extent % tile:
            raise SelectionDeviationError(
                f"{kind}: bucket {name}={extent} is not a multiple of the "
                f"selected l1 tile {tile} (strategy l1={sel.strategy.l1}, "
                f"bucket={sel.bucket}); refusing to clamp the tile"
            )


def _pad_dim(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``dim`` up to ``size`` (the reference path)."""
    pad = [0, 0] * x.ndim
    pad[2 * (x.ndim - 1 - dim) + 1] = size - x.shape[dim]
    return torch.nn.functional.pad(x, pad)


def _example_like(args: tuple, n: int, dtype, device) -> tuple:
    """(dtypes of the first ``n`` args, their device) for ``example_args``:
    the representative call args' when given, else ``dtype`` (float32 by
    default, the reference's) on ``device`` (the CPU by default)."""
    if args:
        return tuple(a.dtype for a in args[:n]), args[0].device
    return (dtype or torch.float32,) * n, torch.device(device or "cpu")


@dataclasses.dataclass(frozen=True)
class Workload:
    """Protocol base.  A workload is viewed through its (m, n, k) contraction:
    ``m`` is the (single) dynamic extent; ``n``/``k`` may be static (GEMM)
    or tied to the dynamic extent (attention's key length).

    Subclasses override the hooks below; the defaults encode the plain-GEMM
    behaviour.
    """

    kind: ClassVar[str] = ""
    # Which tile axes scale with the dynamic extent at runtime.  The selector
    # uses this to enumerate grid breakpoints sample-free (buckets_upto).
    dynamic_tile_axes: ClassVar[tuple[int, ...]] = (0,)

    # ---- call-site binding (registry-driven ops) --------------------------
    # ``dispatch_key`` gives the raw-tuple hot-path key (ints/flags straight
    # off the tensors), ``bind`` constructs the Workload on the first call
    # per key — what makes ``repro_torch.vortex.ops.<kind>`` work with no
    # engine edits.

    @classmethod
    def bind(cls, *args: Any, **kwargs: Any) -> "Workload":
        """Construct the workload instance implied by a call site."""
        raise NotImplementedError(
            f"{cls.__name__} does not define bind(); it cannot be called "
            "through vortex.ops"
        )

    @classmethod
    def dispatch_key(cls, *args: Any, **kwargs: Any) -> tuple | None:
        """Cheap hashable key of the call-site signature (static dims and
        flags, NOT the dynamic extent); None opts out of the cache."""
        return None

    # ---- identity --------------------------------------------------------

    @property
    def signature(self) -> tuple:
        """Engine-level cache key: one compiled VortexKernel per signature."""
        return (self.kind,) + tuple(
            getattr(self, f.name) for f in dataclasses.fields(self)
        )

    @property
    def lattice_key(self) -> tuple:
        """Scored-lattice cache key: the subset of the signature that the
        candidate generator + analyzer actually depend on."""
        return self.signature

    # ---- contraction view ------------------------------------------------

    def runtime_dims(self, m_runtime: int | None = None) -> Tile:
        """Map the dynamic extent to concrete (M, N, K)."""
        raise NotImplementedError


    # ---- capacity models (InitCands hardware limits) ---------------------

    def l0_fragment_bytes(self, tile: Tile) -> int:
        """Register-file bytes of one level-0 operand fragment."""
        m, n, k = tile
        return (m * k + k * n) * self.dtype_bytes + m * n * self.acc_bytes

    def l1_tile_bytes(self, tile: Tile) -> int:
        """Fast-memory working set of one layer-1 tile (double-buffered
        streams + resident f32 accumulator)."""
        m, n, k = tile
        stream = 2 * (m * k + k * n) * self.dtype_bytes
        acc = m * n * self.acc_bytes
        return stream + acc

    def l0_axis_multipliers(self) -> Tile:
        """Upper pow2 multipliers over the native tile for level-0 ranges."""
        return (16, 4, 4)

    def l1_axis_caps(self, native: Tile) -> Tile:
        """Absolute upper bounds for the level-1 pow2 ranges."""
        return (8192, 8192, 8192)

    # ---- Eq. 2 grid-level traffic (scalar or numpy arrays) ---------------

    def tile_traffic_bytes(self, m1, n1, k1) -> tuple:
        """(load, store) HBM bytes per layer-1 tile per reduction step."""
        load = (m1 * k1 + k1 * n1) * self.dtype_bytes
        store = m1 * n1 * self.dtype_bytes
        return load, store

    # ---- runtime geometry -------------------------------------------------

    def bucket_dims(self, grid: Tile, l1: Tile) -> Tile:
        """Executable-cache key shape: padding confined to the dynamic dims
        and only up to the lattice tile; static dims at their true size."""
        _, N, K = self.runtime_dims(1)
        return (grid[0] * l1[0], N, K)

    def dynamic_bucket(self, sel) -> int:
        """The padded DYNAMIC extent of a Selection — what serving layers
        quantize to (``CompiledOp.bucket``)."""
        return sel.padded_m

    # ---- rKernel program --------------------------------------------------

    def program(self, hw: HardwareSpec) -> RKernelProgram:
        raise NotImplementedError

    # ---- execution (engine hooks): the masked-tail staging contract -------
    # The per-bucket executable built by ``build_executable`` consumes
    # bucket-shaped buffers PLUS the true runtime extents as trailing int
    # scalars (``runtime_scalars``) and masks the pad tail in-kernel, so the
    # pad region of a staged buffer may hold ARBITRARY GARBAGE.  The engine:
    #
    #   0. maps the call args to the executable's inputs (``stage_view``:
    #      the identity, or im2col for conv); every hook below but
    #      ``finalize`` sees this VIEW,
    #   1. compares each view arg's shape against ``staged_shapes`` — args
    #      that already match run with ZERO copies (the aligned fast path),
    #   2. copies mismatched args into engine-owned bucket buffers in place
    #      (O(true-size) writes, no allocation, no zero fill) and makes ONE
    #      launch,
    #   3. slices the bucket-shaped output back via ``finalize``.
    #
    # ``prepare`` (zero-pad the args to the bucket) is the REFERENCE path,
    # functionally identical; ``call_padded`` runs it for parity tests.

    # Whether the workload implements the staging contract below (the
    # calibrator measures only such workloads).
    supports_staging: ClassVar[bool] = False
    # Whether finalize() slices a bucket-shaped output on unaligned calls
    # (decode attention's output never depends on the bucket).
    unstages: ClassVar[bool] = True

    def dynamic_extent(self, *args) -> int:
        """The runtime value of the dynamic dim, from the call arguments."""
        raise NotImplementedError

    def exec_key(self, *args) -> tuple:
        """Extra executable-cache key parts beyond the bucket (outer dims
        the executable is specialized on)."""
        return ()

    def stage_view(self, *args) -> tuple:
        """Map call args to the tensors the executable consumes (identity
        unless the workload transforms data first, e.g. im2col)."""
        return args

    def staged_shapes(self, sel, *view) -> tuple:
        """Per view arg: the bucket-shaped staging-buffer shape, or None
        for args passed through unstaged."""
        raise NotImplementedError

    def runtime_scalars(self, sel, *view) -> tuple:
        """True runtime extents appended to every executable call."""
        return ()

    def prepare(self, sel, *view) -> tuple:
        """Reference path: zero-pad the view args to the bucket shapes."""
        raise NotImplementedError

    def finalize(self, sel, out, *args):
        """Slice the bucket-shaped output back to the true extents of the
        RAW call args (a view of the launch's own fresh output, never of
        an engine buffer)."""
        raise NotImplementedError

    def build_executable(self, sel, *, impl: str) -> Callable:
        """Build the bucket-shaped executable for a runtime selection:
        ``fn(*bucket_args, *runtime_scalars) -> bucket-shaped out``.
        ``impl`` is ``"cuda"`` (the hand-written kernel) or ``"torch"``
        (its plain version).  Raises :class:`SelectionDeviationError`
        rather than adjusting the selected tile."""
        raise NotImplementedError

    def example_args(self, sel, *args, dtype=None, device=None) -> tuple:
        """Zero tensors plus extents matching the executable's full
        signature ``fn(*bucket_args, *runtime_scalars)`` at ``sel`` (what
        the calibrator times).  With representative call ``args`` their
        dtypes and device are used, else ``dtype`` on ``device``."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------


@register_workload
@dataclasses.dataclass(frozen=True)
class GemmWorkload(Workload):
    """A (possibly dynamic) GEMM: C[M, N] = A[M, K] @ B[K, N].

    ``dynamic_dims`` lists the dims unknown until runtime (for LM inference
    that is M = batch*seq; N and K are weights-side and static).
    """

    M: int | None
    N: int
    K: int
    dtype_bytes: int = 2
    acc_bytes: int = 4
    dynamic_dims: tuple[str, ...] = ("M",)

    kind: ClassVar[str] = "gemm"
    supports_staging: ClassVar[bool] = True

    @classmethod
    def bind(cls, a, b) -> "GemmWorkload":
        return cls(M=None, N=b.shape[1], K=b.shape[0])

    @classmethod
    def dispatch_key(cls, a, b) -> tuple:
        return (b.shape[0], b.shape[1])

    def runtime_dims(self, m_runtime: int | None = None) -> Tile:
        m = self.M if m_runtime is None else m_runtime
        if m is None:
            raise ValueError("runtime M required for dynamic workloads")
        return (m, self.N, self.K)


    def program(self, hw: HardwareSpec) -> RKernelProgram:
        return _make_program(
            hw,
            self.kind,
            {
                0: ("load_tile_to_reg", "store_reg", "dot"),
                1: ("copy_hbm_to_smem", "copy_smem_to_hbm", ""),
            },
        )

    # -- execution ---------------------------------------------------------

    def dynamic_extent(self, a, b) -> int:
        return a.shape[0]

    def staged_shapes(self, sel, a, b) -> tuple:
        return ((sel.padded_m, self.K), None)

    def runtime_scalars(self, sel, a, b) -> tuple:
        return (a.shape[0],)

    def prepare(self, sel, a, b) -> tuple:
        if sel.padded_m != a.shape[0]:
            a = _pad_dim(a, 0, sel.padded_m)
        return a, b

    def finalize(self, sel, out, a, b):
        m = a.shape[0]
        return out.narrow(0, 0, m) if sel.padded_m != m else out

    def build_executable(self, sel, *, impl: str):
        m1, n1, k1 = sel.strategy.l1
        _check_bucket_tiles(self.kind, sel, (("m", sel.padded_m, m1),))
        if impl == "cuda":
            from repro_torch.kernels.gemm import vortex_gemm

            # The selected tile and backend run verbatim: N/K tails are
            # masked in-kernel, the m pad tail via the runtime extent.
            backend = sel.strategy.backend

            def fn(a, b, m_true):
                return vortex_gemm(
                    a, b, m_true, block_m=m1, block_n=n1, block_k=k1,
                    backend=backend,
                )

        elif impl == "torch":
            from repro_torch.kernels.ref import ref_gemm

            def fn(a, b, m_true):
                # Rows of A @ B are independent, so garbage pad rows cannot
                # reach the real rows; the extent scalar is unused.
                del m_true
                return ref_gemm(a, b)

        else:
            raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
        return fn

    def example_args(self, sel, *args, dtype=None, device=None) -> tuple:
        (da, db), dev = _example_like(args, 2, dtype, device)
        return (
            torch.zeros((sel.padded_m, self.K), dtype=da, device=dev),
            torch.zeros((self.K, self.N), dtype=db, device=dev),
            sel.padded_m,
        )


# ---------------------------------------------------------------------------
# Grouped GEMM (ragged MoE expert FFN)
# ---------------------------------------------------------------------------


@register_workload
@dataclasses.dataclass(frozen=True)
class GroupedGemmWorkload(Workload):
    """Ragged grouped GEMM: out[g] = x[g] @ w[g // (G//E)], per-group extents.

    The MoE expert FFN after capacity-bounded routing: G capacity-shaped
    ``(C, K)`` activation slabs against a stacked ``(E, K, N)`` expert
    weight tensor (``r = G // E`` consecutive groups — expert-major — per
    stack entry).  Only ``counts[g]`` rows of slab g are real.  The
    capacity C is the dynamic extent (a routing outcome); the true extents
    ride into the kernel as a ``(G,)`` int32 DEVICE vector, and one launch
    covers all G groups at any routing skew.

    Selection prices the per-group ``(C, N, K)`` view: G multiplies every
    candidate's time alike, so the per-group argmin is the whole-launch
    argmin and the gemm lattice applies verbatim (``lattice_key`` is the
    literal gemm signature).  :meth:`flops` reports the G-scaled work.

    Call signature: ``grouped_gemm(x, w, counts)``.  Rows of ``x[g]`` at
    or past ``counts[g]`` may hold anything; the matching output rows are
    exactly zero in every impl, so staged dispatch is bit-identical to the
    zero-padded reference path.
    """

    C: int | None  # capacity (rows per group), dynamic
    G: int  # total groups = E * groups_per_expert
    E: int  # weight stack entries
    N: int
    K: int
    dtype_bytes: int = 2
    acc_bytes: int = 4
    dynamic_dims: tuple[str, ...] = ("C",)

    kind: ClassVar[str] = "grouped_gemm"
    supports_staging: ClassVar[bool] = True

    @classmethod
    def bind(cls, x, w, counts) -> "GroupedGemmWorkload":
        return cls(
            C=None, G=x.shape[0], E=w.shape[0], N=w.shape[2], K=w.shape[1]
        )

    @classmethod
    def dispatch_key(cls, x, w, counts) -> tuple:
        return (x.shape[0], w.shape[0], w.shape[1], w.shape[2])

    @property
    def lattice_key(self) -> tuple:
        # The GemmWorkload(M=None, N, K) signature: both kinds hash to one
        # scored-lattice cache entry.
        return (
            "gemm", None, self.N, self.K,
            self.dtype_bytes, self.acc_bytes, ("M",),
        )

    def runtime_dims(self, m_runtime: int | None = None) -> Tile:
        c = self.C if m_runtime is None else m_runtime
        if c is None:
            raise ValueError("runtime capacity required")
        return (c, self.N, self.K)

    def flops(self, m: int | None = None) -> float:
        c, n, k = self.runtime_dims(m)
        return 2.0 * self.G * c * n * k  # the work of all groups

    def program(self, hw: HardwareSpec) -> RKernelProgram:
        return _make_program(
            hw,
            self.kind,
            {
                0: ("load_tile_to_reg", "store_reg", "dot"),
                1: ("copy_hbm_to_smem", "copy_smem_to_hbm", ""),
            },
        )

    # -- execution ---------------------------------------------------------

    def dynamic_extent(self, x, w, counts) -> int:
        return x.shape[1]

    def stage_view(self, x, w, counts) -> tuple:
        # counts as a (G,) int32 tensor on x's device: a no-op for the
        # routing output, a host-to-device copy for a list.
        cnt = torch.as_tensor(counts, device=x.device)
        if cnt.dtype != torch.int32:
            cnt = cnt.to(torch.int32)
        return x, w, cnt.reshape(self.G)

    def staged_shapes(self, sel, x, w, counts) -> tuple:
        # Only the activation slabs are bucket-shaped (on the capacity
        # axis); weights and the counts vector pass through unstaged.
        return ((self.G, sel.padded_m, self.K), None, None)

    def prepare(self, sel, x, w, counts) -> tuple:
        if sel.padded_m != x.shape[1]:
            x = _pad_dim(x, 1, sel.padded_m)
        return x, w, counts

    def finalize(self, sel, out, x, w, counts):
        c = x.shape[1]
        return out.narrow(1, 0, c) if sel.padded_m != c else out

    def build_executable(self, sel, *, impl: str):
        m1, n1, k1 = sel.strategy.l1
        _check_bucket_tiles(self.kind, sel, (("c", sel.padded_m, m1),))
        if impl == "cuda":
            from repro_torch.kernels.grouped_gemm import vortex_grouped_gemm

            backend = sel.strategy.backend

            def fn(x, w, counts):
                return vortex_grouped_gemm(
                    x, w, counts, block_m=m1, block_n=n1, block_k=k1,
                    backend=backend,
                )

        elif impl == "torch":
            from repro_torch.kernels.grouped_gemm import (
                vortex_grouped_gemm_plain as fn,
            )

        else:
            raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
        return fn


    def example_args(self, sel, *args, dtype=None, device=None) -> tuple:
        # Every group full to the bucket (ROADMAP C6): the kernel issues
        # no work past a group's count, so the reference's zero counts
        # would time an empty launch; full counts are the work the Pallas
        # kernel does at any count.
        (dx, dw), dev = _example_like(args, 2, dtype, device)
        return (
            torch.zeros((self.G, sel.padded_m, self.K), dtype=dx, device=dev),
            torch.zeros((self.E, self.K, self.N), dtype=dw, device=dev),
            torch.full((self.G,), sel.padded_m, dtype=torch.int32,
                       device=dev),
        )


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


@register_workload
@dataclasses.dataclass(frozen=True)
class AttentionWorkload(Workload):
    """Flash attention with a dynamic sequence length.

    Both contractions (QK^T: (sq,d)@(d,skv); PV: (sq,skv)@(skv,d)) tile on
    the SAME sequence blocks, so one lattice governs both: the l1 m-tile is
    the query block and the l1 k-tile the key/value block.  The n axis is
    pinned to the native tile — head_dim is static and fits one block.

    Padding correctness comes from an EXPLICIT key-validity mask: the true
    kv length rides along as a runtime scalar and the kernel masks scores
    (and zeroes value rows) past it, so bucket pad — even garbage bytes in
    a staging buffer — never reaches a real query row, causal or not.
    """

    seq: int | None
    head_dim: int
    causal: bool = True
    window: int | None = None
    softcap: float | None = None
    dtype_bytes: int = 2
    acc_bytes: int = 4
    dynamic_dims: tuple[str, ...] = ("seq",)

    kind: ClassVar[str] = "attention"
    supports_staging: ClassVar[bool] = True
    dynamic_tile_axes: ClassVar[tuple[int, ...]] = (0, 2)

    @classmethod
    def bind(
        cls, q, k, v, *, causal: bool = True,
        window: int | None = None, softcap: float | None = None,
    ) -> "AttentionWorkload":
        return cls(
            seq=None, head_dim=q.shape[-1], causal=causal,
            window=window, softcap=softcap,
        )

    @classmethod
    def dispatch_key(
        cls, q, k, v, *, causal: bool = True,
        window: int | None = None, softcap: float | None = None,
    ) -> tuple:
        return (q.shape[-1], causal, window, softcap)

    @property
    def lattice_key(self) -> tuple:
        # Masking flags don't move tile costs; share scored lattices.
        return (self.kind, self.head_dim, self.dtype_bytes, self.acc_bytes)

    def runtime_dims(self, m_runtime: int | None = None) -> Tile:
        s = self.seq if m_runtime is None else m_runtime
        if s is None:
            raise ValueError("runtime seq required")
        return (s, self.head_dim, s)


    def l1_tile_bytes(self, tile: Tile) -> int:
        m1, _, k1 = tile
        d = self.head_dim
        stream = 2 * (m1 * d + 2 * k1 * d) * self.dtype_bytes  # Q + K,V
        resident = m1 * d * self.acc_bytes + m1 * k1 * 4  # acc + f32 scores
        return stream + resident

    def l0_axis_multipliers(self) -> Tile:
        return (16, 1, 4)  # n pinned to the native tile

    def l1_axis_caps(self, native: Tile) -> Tile:
        return (8192, native[1], 8192)

    def tile_traffic_bytes(self, m1, n1, k1) -> tuple:
        d = self.head_dim
        load = 2 * k1 * d * self.dtype_bytes  # stream K and V blocks
        store = m1 * d * self.dtype_bytes  # output block, once per tile
        return load, store

    def bucket_dims(self, grid: Tile, l1: Tile) -> Tile:
        return (grid[0] * l1[0], self.head_dim, grid[2] * l1[2])

    def program(self, hw: HardwareSpec) -> RKernelProgram:
        return _make_program(
            hw,
            self.kind,
            {
                0: ("load_tile_to_reg", "store_reg", "dot"),
                1: ("copy_qkv_to_smem", "online_softmax_store", ""),
            },
        )

    # -- execution ---------------------------------------------------------

    def dynamic_extent(self, q, k, v) -> int:
        if q.shape[-2] != k.shape[-2]:
            raise ValueError(
                "engine attention is self-attention: query/key lengths must "
                f"match, got {q.shape[-2]} vs {k.shape[-2]}"
            )
        return q.shape[-2]

    def exec_key(self, q, k, v) -> tuple:
        # Outer (batch, heads) dims specialize the executable.
        return (q.shape[0], q.shape[1], k.shape[1])

    def staged_shapes(self, sel, q, k, v) -> tuple:
        pq, d, pkv = sel.bucket
        b, hq, _, _ = q.shape
        hkv = k.shape[1]
        return (
            (b, hq, pq, d),
            (b, hkv, pkv, d),
            (b, hkv, pkv, d),
        )

    def runtime_scalars(self, sel, q, k, v) -> tuple:
        return (k.shape[-2],)

    def prepare(self, sel, q, k, v) -> tuple:
        pq, _, pkv = sel.bucket
        if pq != q.shape[-2]:
            q = _pad_dim(q, 2, pq)
        if pkv != k.shape[-2]:
            k = _pad_dim(k, 2, pkv)
            v = _pad_dim(v, 2, pkv)
        return q, k, v

    def finalize(self, sel, out, q, k, v):
        sq = q.shape[-2]
        return out.narrow(2, 0, sq) if sel.bucket[0] != sq else out

    def build_executable(self, sel, *, impl: str):
        pq, _, pkv = sel.bucket
        m1, _, k1 = sel.strategy.l1
        _check_bucket_tiles(
            self.kind, sel, (("q", pq, m1), ("kv", pkv, k1))
        )
        causal, window, softcap = self.causal, self.window, self.softcap
        backend = sel.strategy.backend

        if impl == "cuda":
            from repro_torch.kernels.attention import flash_attention

            def fn(q, k, v, kv_len):
                return flash_attention(
                    q, k, v, kv_len, block_q=m1, block_k=k1,
                    backend=backend, causal=causal, window=window,
                    softcap=softcap,
                )

        elif impl == "torch":
            from repro_torch.kernels.ref import chunked_attention

            def fn(q, k, v, kv_len):
                return chunked_attention(
                    q, k, v, causal=causal, window=window, softcap=softcap,
                    chunk=k1, kv_len=kv_len,
                )

        else:
            raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
        return fn


    def example_args(self, sel, *args, dtype=None, device=None) -> tuple:
        pq, d, pkv = sel.bucket
        b, hq, hkv = self.exec_key(*args) if args else (1, 1, 1)
        dts, dev = _example_like(args, 3, dtype, device)
        return (
            torch.zeros((b, hq, pq, d), dtype=dts[0], device=dev),
            torch.zeros((b, hkv, pkv, d), dtype=dts[1], device=dev),
            torch.zeros((b, hkv, pkv, d), dtype=dts[2], device=dev),
            pkv,
        )


# ---------------------------------------------------------------------------
# Decode attention (q_len == 1 against a kv-bucketed cache)
# ---------------------------------------------------------------------------


@register_workload
@dataclasses.dataclass(frozen=True)
class DecodeAttentionWorkload(AttentionWorkload):
    """Single-token decode attention against a KV cache.

    The DYNAMIC extent is the cache length S.  Selection prices the same
    (S, head_dim, S) view as prefill :class:`AttentionWorkload` (a literal
    (1, d, S) view makes Eq. 2-4 flat in the k-tile and degenerates to a
    bucket every 2 tokens), so the decode kv-bucket set IS the prefill
    kv-bucket set and the scored lattice is shared (same ``lattice_key``).
    Only the q block differs at execution: the kernel runs block_q == 1.
    The TRUE number of valid cache rows rides as ``kv_len`` (a Python int,
    or a (b,) vector for rows at mixed progress): scores past it are masked
    and value rows zeroed, so the cache tail beyond ``kv_len`` can never
    reach the query row.  Causality needs no flag: the query sits at
    absolute position ``kv_len - 1``.

    Call signature: ``decode_attention(q, k, v, kv_len)`` with q
    (b, hq, 1, d) and k/v (b, hkv, S, d), S >= kv_len.
    """

    kind: ClassVar[str] = "decode_attention"
    unstages: ClassVar[bool] = False  # out is (b, hq, 1, d): nothing to slice

    @classmethod
    def bind(
        cls, q, k, v, kv_len, *,
        window: int | None = None, softcap: float | None = None,
    ) -> "DecodeAttentionWorkload":
        return cls(
            seq=None, head_dim=q.shape[-1], causal=True,
            window=window, softcap=softcap,
        )

    @classmethod
    def dispatch_key(
        cls, q, k, v, kv_len, *,
        window: int | None = None, softcap: float | None = None,
    ) -> tuple:
        return (q.shape[-1], window, softcap)

    @property
    def lattice_key(self) -> tuple:
        # The literal kind string (NOT self.kind): decode shares prefill
        # attention's scored lattices.
        return ("attention", self.head_dim, self.dtype_bytes, self.acc_bytes)

    # runtime_dims stays the inherited (S, head_dim, S) prefill view — the
    # selection pricing contract above.


    def bucket_dims(self, grid: Tile, l1: Tile) -> Tile:
        return (1, self.head_dim, grid[2] * l1[2])

    def dynamic_bucket(self, sel) -> int:
        return sel.bucket[2]

    # -- execution ---------------------------------------------------------

    def dynamic_extent(self, q, k, v, kv_len) -> int:
        if q.shape[-2] != 1:
            raise ValueError(
                f"decode attention takes ONE query row, got q_len={q.shape[-2]}"
            )
        return k.shape[-2]

    def exec_key(self, q, k, v, kv_len) -> tuple:
        # kv_len's rank is part of the key: scalar and per-row extents are
        # different executables (as in the reference's AOT cache).
        return (
            q.shape[0], q.shape[1], k.shape[1],
            getattr(kv_len, "ndim", 0),
        )

    def staged_shapes(self, sel, q, k, v, kv_len) -> tuple:
        _, d, pkv = sel.bucket
        b, hkv = k.shape[0], k.shape[1]
        return (None, (b, hkv, pkv, d), (b, hkv, pkv, d), None)

    def runtime_scalars(self, sel, q, k, v, kv_len) -> tuple:
        return ()  # kv_len already rides in the call args

    def prepare(self, sel, q, k, v, kv_len) -> tuple:
        pkv = sel.bucket[2]
        if pkv != k.shape[-2]:
            k = _pad_dim(k, 2, pkv)
            v = _pad_dim(v, 2, pkv)
        return q, k, v, kv_len

    def finalize(self, sel, out, q, k, v, kv_len):
        return out  # (b, hq, 1, d) — never bucket-shaped

    def build_executable(self, sel, *, impl: str):
        pkv = sel.bucket[2]
        _, _, k1 = sel.strategy.l1
        _check_bucket_tiles(self.kind, sel, (("kv", pkv, k1),))
        window, softcap = self.window, self.softcap
        backend = sel.strategy.backend

        if impl == "cuda":
            from repro_torch.kernels.attention import flash_attention

            def fn(q, k, v, kv_len):
                # causal=False: the kv_len validity mask already excludes
                # every key past the query's absolute position kv_len-1.
                return flash_attention(
                    q, k, v, kv_len, q_offset=kv_len - 1,
                    block_q=1, block_k=k1, backend=backend, causal=False,
                    window=window, softcap=softcap,
                )

        elif impl == "torch":
            from repro_torch.kernels.ref import chunked_attention

            def fn(q, k, v, kv_len):
                return chunked_attention(
                    q, k, v, causal=False, window=window, softcap=softcap,
                    chunk=k1, offset=kv_len - 1, kv_len=kv_len,
                )

        else:
            raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
        return fn


    def example_args(self, sel, *args, dtype=None, device=None) -> tuple:
        _, d, pkv = sel.bucket
        b, hq, hkv, kv_ndim = self.exec_key(*args) if args else (1, 1, 1, 0)
        dts, dev = _example_like(args, 3, dtype, device)
        # kv_len's rank matches the live calls' (a (b,) vector is per-row).
        kv_ex = (torch.full((b,), pkv, dtype=torch.int32, device=dev)
                 if kv_ndim else pkv)
        return (
            torch.zeros((b, hq, 1, d), dtype=dts[0], device=dev),
            torch.zeros((b, hkv, pkv, d), dtype=dts[1], device=dev),
            torch.zeros((b, hkv, pkv, d), dtype=dts[2], device=dev),
            kv_ex,
        )


# ---------------------------------------------------------------------------
# Conv2D (im2col GEMM view)
# ---------------------------------------------------------------------------


@register_workload
@dataclasses.dataclass(frozen=True)
class Conv2dWorkload(Workload):
    """Conv2D (VALID padding) lowered to the hierarchized GEMM space.

    im2col turns Conv2D into a GEMM with M = b*h'*w' (dynamic batch and
    spatial extents), N = cout, K = kh*kw*cin — after which the lattice,
    analyzer and selector apply unchanged (paper Table 4).  ``stage_view``
    is the im2col, so the engine stages the patch matrix, and the
    executable is the GEMM workload's.

    Call signature: ``conv2d(x, w, stride=...)`` with x (b, h, w, cin) and
    w (kh, kw, cin, cout).
    """

    m: int | None  # b*h'*w', dynamic
    cin: int
    cout: int
    kh: int
    kw: int
    stride: int = 1
    dtype_bytes: int = 2
    acc_bytes: int = 4
    dynamic_dims: tuple[str, ...] = ("m",)

    kind: ClassVar[str] = "conv2d"
    supports_staging: ClassVar[bool] = True

    @classmethod
    def bind(cls, x, w, *, stride: int = 1) -> "Conv2dWorkload":
        kh, kw, cin, cout = w.shape
        return cls(m=None, cin=cin, cout=cout, kh=kh, kw=kw, stride=stride)

    @classmethod
    def dispatch_key(cls, x, w, *, stride: int = 1) -> tuple:
        return (*w.shape, stride)

    @property
    def N(self) -> int:
        return self.cout

    @property
    def K(self) -> int:
        return self.kh * self.kw * self.cin

    def runtime_dims(self, m_runtime: int | None = None) -> Tile:
        m = self.m if m_runtime is None else m_runtime
        if m is None:
            raise ValueError("runtime output-pixel count required")
        return (m, self.N, self.K)

    def program(self, hw: HardwareSpec) -> RKernelProgram:
        return _make_program(
            hw,
            self.kind,
            {
                0: ("load_tile_to_reg", "store_reg", "dot"),
                1: ("im2col_hbm_to_smem", "copy_smem_to_hbm", ""),
            },
        )

    # -- execution ---------------------------------------------------------

    def _out_hw(self, x) -> tuple[int, int]:
        _, h, w, _ = x.shape
        return (
            (h - self.kh) // self.stride + 1,
            (w - self.kw) // self.stride + 1,
        )

    def dynamic_extent(self, x, w) -> int:
        ho, wo = self._out_hw(x)
        return x.shape[0] * ho * wo

    def stage_view(self, x, w) -> tuple:
        from repro_torch.kernels.conv import conv_weight_matrix, im2col

        cols, _ = im2col(x, self.kh, self.kw, self.stride)
        return cols, conv_weight_matrix(w)

    def staged_shapes(self, sel, cols, wmat) -> tuple:
        return ((sel.padded_m, self.K), None)

    def runtime_scalars(self, sel, cols, wmat) -> tuple:
        return (cols.shape[0],)

    def prepare(self, sel, cols, wmat) -> tuple:
        if sel.padded_m != cols.shape[0]:
            cols = _pad_dim(cols, 0, sel.padded_m)
        return cols, wmat

    def finalize(self, sel, out, x, w):
        ho, wo = self._out_hw(x)
        m = x.shape[0] * ho * wo
        # out[:m] of the launch's fresh (padded_m, cout) output is
        # contiguous, so the reshape is a view of it.
        return out.narrow(0, 0, m).view(x.shape[0], ho, wo, self.cout)

    def build_executable(self, sel, *, impl: str):
        # The executable is the GEMM kernel on the im2col matrix; the
        # expansion itself runs in stage_view().
        return GemmWorkload(
            M=None, N=self.N, K=self.K, dtype_bytes=self.dtype_bytes,
            acc_bytes=self.acc_bytes,
        ).build_executable(sel, impl=impl)

    def example_args(self, sel, *args, dtype=None, device=None) -> tuple:
        # args are the raw (x, w) call args; the executable consumes the
        # im2col view, which keeps the input dtypes.
        (dx, dw), dev = _example_like(args, 2, dtype, device)
        return (
            torch.zeros((sel.padded_m, self.K), dtype=dx, device=dev),
            torch.zeros((self.K, self.N), dtype=dw, device=dev),
            sel.padded_m,
        )
