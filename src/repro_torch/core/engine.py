"""VortexKernel: the end-to-end sample-free compiler (paper Fig. 6).

Offline stage (no shape samples anywhere):
  1. top-down: describe the workload as an rKernel program (workloads.py),
  2. bottom-up: generate the hardware-pruned candidate lattice per backend
     (candidates.py, Algorithm 2),
  3. score it with the hybrid analyzer (analyzer.py).

Runtime stage:
  4. given the actual shape, select strategy + launch geometry + backend
     (selector.py) — a bisect into the offline-materialized selection table
     on the hot path,
  5. fetch the executable for the induced bucket and make ONE launch,
     staging unaligned extents into engine-owned bucket buffers.

Executables: ``impl="cuda"`` launches the hand-written Hopper kernels
(kernels/, csrc/); ``impl="torch"`` runs their plain PyTorch versions (the
CPU lowering, counterpart of the reference's ``impl="xla"``).  PyTorch runs
eagerly, so the reference's one AOT program per bucket becomes one kernel
launch per call (and, inside a served decode step, one node of the step's
CUDA graph: launch/graphs.py).  An unaligned call stages every operand in
one launch of the staging kernel (kernels/stage.py).

A candidate that raises at executable build or launch walks the
degradation ladder (``_degrade``, DESIGN.md §11): it is quarantined and
the next-best lattice candidate is retried up to ``max_retries`` times.
For CPU operands the last rung runs the plain PyTorch versions
(``impl="torch"``), as the reference's last rung does.  Operands on the
card never reach a plain version: there the ladder ends with the last
hand-written candidate, and when that fails too the call raises
:class:`LadderExhaustedError` (ROADMAP C10).  The ladder catches what a
launch raises synchronously -- a wrapper's ``ValueError`` for a tile it
refuses, a nonzero ``cudaError_t`` returned by a kernel's launch, an
injected fault (runtime/faults.py).  An asynchronous device fault (an
illegal address) poisons the CUDA context and no rung recovers from it;
the hot path adds no synchronize to find one.  Two errors are no
candidate's fault and propagate with nothing quarantined: a kernel
library that fails to build (:class:`KernelLibraryError`) and operands a
wrapper refuses whatever the tile (``kernels.gemm.OperandError``: a
stride, dtype, device or shape the kernels do not take).  Quarantines
persist through a :class:`~repro_torch.core.denylist.DenylistStore` once
a lower rung succeeds.

A :class:`LazyBucket` is a bucket-shaped launch output not yet sliced to
its true extent; a dispatch that receives one at a position its workload
declares in ``consumes_staged`` hands the raw buffer to the kernel
(``_call_forwarded``), so chained engine ops cross their boundaries with
no unstage and no restage (the prefill chain, launch/serve.py
``prefill="chained"``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import torch

from repro_torch.core.analyzer import HybridAnalyzer, Profiler, ScoredLattice
from repro_torch.core.candidates import generate_lattice
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.selector import RuntimeSelector, Selection
from repro_torch.core.workloads import Workload
from repro_torch.kernels.gemm import OperandError
from repro_torch.kernels.stage import StagePlan
from repro_torch.runtime import faults

__all__ = [
    "DispatchStats",
    "KernelLibraryError",
    "LadderExhaustedError",
    "LazyBucket",
    "OfflineStats",
    "PrecompileError",
    "VortexKernel",
    "lazy_map",
]


@dataclasses.dataclass(frozen=True)
class OfflineStats:
    """Offline-stage accounting (paper §7.4 'Offline Overhead Analysis')."""

    num_candidates: int
    num_measured: int
    build_seconds: float
    backends: tuple[str, ...]


class PrecompileError(RuntimeError):
    """A bucket failed to build during :meth:`VortexKernel.precompile`;
    the message names the failing Selection."""

    def __init__(self, kind: str, sel: Selection, cause: BaseException):
        self.kind = kind
        self.selection = sel
        super().__init__(
            f"precompile failed for workload {kind!r}: bucket={sel.bucket} "
            f"backend={sel.backend} strategy l1={sel.strategy.l1} "
            f"grid={sel.grid}: {type(cause).__name__}: {cause}"
        )


class KernelLibraryError(RuntimeError):
    """The hand-written kernels' library failed to build or load (no
    ``nvcc``, a compile error): every candidate would fail alike, so the
    degradation ladder lets it through instead of quarantining the lattice
    and falling back to the plain versions for good."""


class LadderExhaustedError(RuntimeError):
    """Every hand-written candidate the degradation ladder tried for a
    call on the card failed.  The card has no plain-version rung, so the
    call raises; its quarantines are rolled back and nothing persists."""


# Errors the ladder lets through untouched: no candidate is at fault.
_NOT_A_CANDIDATE = (KernelLibraryError, OperandError)


def _on_card(args: tuple) -> bool:
    """True if any operand lies on a CUDA device (no plain-version rung)."""
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


@dataclasses.dataclass
class DispatchStats:
    """Per-call accounting for the serving hot path, with the reference's
    fields and meanings.

    ``launches`` counts executions of the ONE per-bucket executable;
    ``stage_copies``/``unstage_copies`` count the O(true-size) boundary
    copies an unaligned extent pays (the in-place copy into an engine
    buffer / the output slice back).  ``padded_calls`` counts calls on the
    zero-pad reference path.

    ``forwarded`` counts :class:`LazyBucket` operands whose buffer entered
    the next launch directly -- an op boundary crossed with NO unstage and
    NO restage; ``realize_slices`` counts deferred output slices forced by
    a non-engine consumer (``LazyBucket.realize``/``clamp``).  Whole-chain
    boundary traffic is exactly ``stage_copies + unstage_copies +
    realize_slices``.  ``traced_calls`` belongs to a path this package
    does not have (calls traced inside an enclosing jit) and stays 0.

    ``quarantined`` counts candidates the degradation ladder denylisted
    after a build or launch failure; ``fallbacks`` counts dispatches of
    CPU operands that exhausted the lattice retries and ran the
    ``impl="torch"`` rung (operands on the card have no such rung, so
    there it stays 0).  Both are zero on every healthy host.
    """

    calls: int = 0
    launches: int = 0
    aligned_calls: int = 0
    unaligned_calls: int = 0
    stage_copies: int = 0
    unstage_copies: int = 0
    padded_calls: int = 0
    traced_calls: int = 0
    forwarded: int = 0
    realize_slices: int = 0
    fallbacks: int = 0
    quarantined: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class LazyBucket:
    """A bucket-shaped engine result that has NOT been sliced to its true
    extent: ``buffer`` is the launch's own output (rows past ``extent``
    along ``axis`` hold garbage the masked-tail contract never reads),
    ``extent`` the true dynamic size.

    ``.shape`` reports the TRUE shape, so workload hooks that read only
    ``.shape``/``.dtype`` (``bind``, ``dispatch_key``,
    ``dynamic_extent``) treat a handle as the realized tensor.
    Realization -- the deferred output slice -- happens once, when a
    non-engine consumer forces it through :meth:`realize` or a torch
    function (``__torch_function__`` realizes every handle argument,
    the counterpart of the reference's ``__jax_array__``).  An engine
    dispatch whose operand is a handle in a compatible bucket consumes
    ``buffer`` directly (``DispatchStats.forwarded``).

    The buffer is always a launch's fresh output (or a row-local function
    of one), never an engine staging buffer or a CUDA graph's static
    output, so nothing the engine reuses is ever aliased.  Handles are
    eager-only plumbing between dispatches.
    """

    __slots__ = ("buffer", "extent", "axis", "_stats", "_lock", "_realized")

    def __init__(self, buffer, extent, axis, stats=None, lock=None):
        self.buffer = buffer
        self.extent = int(extent)
        self.axis = axis
        self._stats = stats
        self._lock = lock
        self._realized = None

    # -- shape surface (what shape-reading hooks consume) ------------------

    @property
    def shape(self) -> tuple:
        s = list(self.buffer.shape)
        s[self.axis] = self.extent
        return tuple(s)

    @property
    def dtype(self):
        return self.buffer.dtype

    @property
    def device(self):
        return self.buffer.device

    @property
    def ndim(self) -> int:
        return self.buffer.ndim

    @property
    def padded_extent(self) -> int:
        """The bucket size the buffer is shaped to along ``axis``."""
        return self.buffer.shape[self.axis]

    @property
    def is_aligned(self) -> bool:
        return self.padded_extent == self.extent

    def _count_slice(self) -> None:
        if self._stats is not None:
            if self._lock is not None:
                with self._lock:
                    self._stats.realize_slices += 1
            else:
                self._stats.realize_slices += 1

    def realize(self) -> torch.Tensor:
        """The true-extent tensor (the deferred unstage).  Identity for an
        aligned bucket; otherwise ONE counted slice into a dense tensor (as
        the reference's slice is a fresh array; the kernels take dense
        operands), cached so repeated forcing pays once."""
        if self._realized is None:
            if self.is_aligned:
                self._realized = self.buffer
            else:
                self._realized = self.buffer.narrow(
                    self.axis, 0, self.extent).contiguous()
                self._count_slice()
        return self._realized

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_realized(args), **_realized(kwargs or {}))

    def rewrap(self, buffer, extent=None, axis=None) -> "LazyBucket":
        """A new handle over ``buffer`` sharing this handle's copy
        accounting -- for extent-preserving reshapes/transposes between
        dispatches (split/merge heads, flattening batch into rows)."""
        return LazyBucket(
            buffer,
            self.extent if extent is None else extent,
            self.axis if axis is None else axis,
            self._stats,
            self._lock,
        )

    def map(self, fn) -> "LazyBucket":
        """Apply a ROW-LOCAL ``fn`` (output row i depends only on input row
        i along ``axis``) to the raw buffer: garbage tail rows stay confined
        past ``extent``.  The handle's bucket geometry must survive."""
        out = fn(self.buffer)
        if out.shape[self.axis] != self.padded_extent:
            raise ValueError(
                f"map changed the bucket axis: {self.padded_extent} -> "
                f"{out.shape[self.axis]}"
            )
        return self.rewrap(out)

    def clamp(self, padded: int) -> "LazyBucket":
        """This handle re-bucketed to ``padded`` rows along ``axis`` (true
        extent unchanged).  Identity when already that size; otherwise one
        counted boundary slice into a dense buffer -- how chain callers pin
        a dispatch output that came back in a larger bucket to the chain's
        width."""
        if self.padded_extent == padded:
            return self
        if padded < self.extent:
            raise ValueError(
                f"cannot clamp below the true extent: {padded} < "
                f"{self.extent}"
            )
        buf = self.buffer.narrow(self.axis, 0, padded).contiguous()
        self._count_slice()
        return self.rewrap(buf)

    def __repr__(self) -> str:
        return (
            f"LazyBucket(shape={self.shape}, padded_extent="
            f"{self.padded_extent}, axis={self.axis}, dtype={self.dtype})"
        )


def _realized(tree):
    """``tree`` (nested tuples/lists/dicts) with every handle realized."""
    if isinstance(tree, LazyBucket):
        return tree.realize()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_realized(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _realized(v) for k, v in tree.items()}
    return tree


def lazy_map(fn, *xs):
    """Apply an elementwise/row-local ``fn`` across tensors and LazyBuckets
    without realizing: the chain glue for the non-engine ops between
    dispatches (norms, residual adds, activations).

    ``fn`` must be ROW-LOCAL along the handles' bucket axis.  All handle
    operands must share (axis, padded_extent) -- then ``fn`` runs on the
    raw buffers and the result is re-wrapped (extent = min of the
    operands', so any row past a partial operand's extent is
    conservatively garbage).  Incompatible handles fall back to realizing
    everything (counted).  Plain operands must broadcast against the
    BUFFER shape (e.g. per-feature norm weights).  With no handle operands
    this is ``fn(*xs)``.
    """
    handles = [x for x in xs if isinstance(x, LazyBucket)]
    if not handles:
        return fn(*xs)
    ref = handles[0]
    if any(
        h.axis != ref.axis or h.padded_extent != ref.padded_extent
        for h in handles[1:]
    ):
        return fn(
            *(x.realize() if isinstance(x, LazyBucket) else x for x in xs)
        )
    out = fn(*(x.buffer if isinstance(x, LazyBucket) else x for x in xs))
    if out.shape[ref.axis] != ref.padded_extent:
        raise ValueError(
            "lazy_map fn changed the bucket axis: "
            f"{ref.padded_extent} -> {out.shape[ref.axis]}"
        )
    return ref.rewrap(out, extent=min(h.extent for h in handles))


def _stream_key(device: torch.device):
    """The stream that orders work on ``device`` for this caller: its raw
    handle (the one query ``torch.cuda.current_stream(device).cuda_stream``
    makes, without building a Stream object); None on the CPU."""
    if device.type == "cuda":
        return torch._C._cuda_getCurrentRawStream(device.index)
    return None


class _BufferSet(dict):
    """One staging-buffer set (call-arg index -> bucket-shaped buffer),
    the ``need`` it was made for, and its staging plans, one per (operands,
    true extents): a repeat call builds no slices and no launch table."""

    __slots__ = ("need", "_plans")

    def __init__(self, bufs: dict, need: tuple):
        super().__init__(bufs)
        self.need = need
        self._plans: dict[tuple, StagePlan] = {}

    def stage(self, idx: list[int], xs: list[torch.Tensor], stream) -> None:
        """Copy each ``xs[j]`` into the leading corner of buffer
        ``idx[j]`` IN PLACE, every operand in one launch on ``stream`` on
        the card (:class:`~repro_torch.kernels.stage.StagePlan`): only
        the true extent is written; the pad tail keeps whatever stale
        bytes it held (the masked-tail kernels never read them)."""
        key = (tuple(idx), tuple(x.shape for x in xs))
        plan = self._plans.get(key)
        if plan is None:
            plan = StagePlan([self[i] for i in idx], key[1])
            self._plans[key] = plan
        plan.run(xs, stream)


class _StagingPool:
    """A small pool of engine-owned staging-buffer SETS for one cache entry.

    One set (call-arg index -> bucket-shaped buffer) serves one in-flight
    unaligned dispatch: concurrent same-bucket calls each check out their
    own set.  Buffers are never re-zeroed; correctness is the kernel's
    kv_len/m_true masking.  Retention is an LRU bounded at ``cap`` sets
    (``EngineConfig.staging_pool_cap``): a release lands at the MRU end
    and evicts from the LRU end when over cap; a checked-out set is not in
    the free list, so eviction never touches an in-flight dispatch.

    A set is handed back right after its launch is ENQUEUED, tagged with
    the stream that launch runs on (``stream``: the caller's
    :func:`_stream_key`, queried once per call), and is reused only by a
    caller on that same stream: the stream orders the pending launch (the
    reader) before the next staging copy (the writer).  A caller on another
    stream gets a fresh set instead.  ``allocs`` counts the fresh sets.
    """

    __slots__ = ("cap", "allocs", "_lock", "_free")

    def __init__(self, cap: int = 4):
        self.cap = cap
        self.allocs = 0
        self._lock = threading.Lock()
        self._free: list[tuple[object, _BufferSet]] = []

    def acquire(self, need: tuple, device: torch.device, stream) -> _BufferSet:
        """A buffer set satisfying ``need`` (``((index, shape tuple,
        dtype), ...)`` on ``device``): a pooled one made for the same need
        from ``stream``, else fresh zero-initialized buffers (zeros only so
        a fresh buffer never leaks earlier bytes through the never-read
        pad)."""
        key = (device, stream)
        with self._lock:
            for i in range(len(self._free) - 1, -1, -1):  # MRU first
                k, bufs = self._free[i]
                if k == key and bufs.need == need:
                    return self._free.pop(i)[1]
            self.allocs += 1
        return _BufferSet({
            idx: torch.zeros(shape, dtype=dtype, device=device)
            for idx, shape, dtype in need
        }, need)

    def release(self, bufs: _BufferSet, device: torch.device,
                stream) -> None:
        with self._lock:
            self._free.append(((device, stream), bufs))  # MRU end
            while len(self._free) > self.cap:
                self._free.pop(0)  # evict LRU

    @property
    def retained(self) -> list[_BufferSet]:
        """The currently pooled buffer sets (tests poison these)."""
        return [bufs for _, bufs in self._free]


@dataclasses.dataclass
class _CacheEntry:
    """One per-bucket executable + its engine-owned staging state."""

    fn: Callable
    compile_seconds: float
    pool: _StagingPool | None  # None: the plain rung, which stages nothing
    hits: int = 0

    def run(self, *args):
        if faults.ACTIVE is not None:
            faults.ACTIVE.check("aot_launch")
        return self.fn(*args)


class VortexKernel:
    """One dynamic-shape workload, compiled sample-free.

    Generic over the Workload protocol: the workload declares its lattice
    footprints, its runtime-dims view and its executable builder; this class
    owns the offline build (lattice + scoring, optionally shared through
    ``scored_cache``), the runtime selector and the bucketed executable
    cache.

    ``table_m_max``/``table_extend_limit`` size the selector's offline
    selection table; ``staging=False`` sends every call to the zero-pad
    reference path; ``staging_pool_cap`` bounds each entry's retained
    staging-buffer sets; ``max_retries`` bounds the degradation ladder's
    re-selections and ``denylist`` (a :class:`~repro_torch.core.denylist.
    DenylistStore` or None) persists its quarantines.
    :class:`repro_torch.vortex.EngineConfig` threads all six through.
    """

    def __init__(
        self,
        hw: HardwareSpec,
        wl: Workload,
        *,
        impl: str,
        profiler: Profiler | None = None,
        empirical_levels: tuple[int, ...] = (0,),
        backends: tuple[str, ...] | None = None,
        num_cores: int = 1,
        scored_cache: dict | None = None,
        table_m_max: int = 4096,
        table_extend_limit: int = 1 << 17,
        staging: bool = True,
        staging_pool_cap: int = 4,
        max_retries: int = 2,
        denylist=None,
    ):
        if impl not in ("cuda", "torch"):
            raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
        self._hw = hw
        self._wl = wl
        self._impl = impl
        self._staging = staging
        self._pool_cap = staging_pool_cap
        self._max_retries = max(int(max_retries), 0)
        # The degradation ladder's quarantine: string keys of candidates
        # that failed at build or launch on THIS host, seeded from the
        # persisted denylist (the calibration cache's fingerprint key) so a
        # restart never re-fails a known-bad candidate.  Empty on every
        # healthy host, so the hot path pays one falsy set check.
        self._denylist = denylist
        self._sig_key = repr(wl.signature)
        self._quarantined: set[str] = (
            set(denylist.get(self._sig_key)) if denylist is not None
            else set()
        )
        self.dispatch_stats = DispatchStats()
        t0 = time.perf_counter()
        backends = backends or tuple(hw.backends)
        scored: dict[str, ScoredLattice] = {}
        n_cands = 0
        n_meas = 0
        for backend in backends:
            cache_key = (wl.lattice_key, hw.name, backend, empirical_levels)
            hit = scored_cache.get(cache_key) if scored_cache is not None \
                else None
            if hit is not None:
                scored[backend] = hit
                continue
            lattice = generate_lattice(hw, wl, backend)
            n_cands += lattice.num_candidates()
            analyzer = HybridAnalyzer(
                hw, wl, profiler=profiler, empirical_levels=empirical_levels
            )
            sl = analyzer.score(lattice)
            n_meas += sl.num_measured
            scored[backend] = sl
            if scored_cache is not None:
                scored_cache[cache_key] = sl
        self.selector = RuntimeSelector(
            hw, wl, scored, num_cores=num_cores,
            table_m_max=table_m_max, table_extend_limit=table_extend_limit,
        )
        self.offline_stats = OfflineStats(
            num_candidates=n_cands,
            num_measured=n_meas,
            build_seconds=time.perf_counter() - t0,
            backends=backends,
        )
        self._exec_cache: dict[tuple, _CacheEntry] = {}
        # (dtype, device) of the first call that built an executable: what
        # the calibrator measures in (ROADMAP C5).  Set on the cache-miss
        # path only; the steady-state dispatch never touches it.
        self._served_as: tuple[torch.dtype, torch.device] | None = None
        # DispatchStats increments are read-modify-writes; concurrent
        # same-bucket dispatch would lose counts without this.
        self._stats_lock = threading.Lock()

    @property
    def workload(self) -> Workload:
        return self._wl

    @property
    def impl(self) -> str:
        return self._impl

    @property
    def served_as(self) -> tuple[torch.dtype, torch.device] | None:
        """(dtype, device) of the calls this kernel has served (its first
        call's leading tensor), or None before any call."""
        return self._served_as

    # -- executable construction ------------------------------------------

    def _build_executable(self, sel: Selection) -> _CacheEntry:
        if faults.ACTIVE is not None:
            faults.ACTIVE.check("precompile")
        t0 = time.perf_counter()
        fn = self._wl.build_executable(sel, impl=self._impl)
        if self._impl == "cuda":
            from repro_torch.kernels.build import library

            try:
                library()  # nvcc at first use; later entries find it built
            except Exception as e:
                raise KernelLibraryError(
                    f"the CUDA kernel library did not build: {e}") from e
        return _CacheEntry(fn=fn, compile_seconds=time.perf_counter() - t0,
                           pool=_StagingPool(self._pool_cap))

    def _exec_cache_key(self, sel: Selection, args: tuple) -> tuple:
        return (
            sel.bucket, sel.strategy.l1, sel.backend, self._impl,
            self._wl.exec_key(*args) if args else (),
        )

    def _entry_for(self, sel: Selection, args: tuple = ()) -> _CacheEntry:
        key = self._exec_cache_key(sel, args)
        entry = self._exec_cache.get(key)
        if entry is None:
            entry = self._build_executable(sel)
            self._exec_cache[key] = entry
            if self._served_as is None and args:
                self._served_as = (args[0].dtype, args[0].device)
        entry.hits += 1
        return entry

    # -- public API ---------------------------------------------------------

    def select(self, m: int) -> Selection:
        return self.selector.select(m)

    def precompile(self, m_max: int, *args) -> int:
        """Build every bucket's executable reachable for M <= m_max
        (sample-free: the bucket set comes from the lattice).  Workloads
        whose executables specialize on outer dims (``exec_key``) need
        representative call ``args``; only their shapes matter.  A failing
        bucket raises :class:`PrecompileError` naming its Selection."""
        sels = self.selector.selections_upto(m_max)
        for sel in sels:
            key = self._exec_cache_key(sel, args)
            if key in self._exec_cache:
                continue
            try:
                self._exec_cache[key] = self._build_executable(sel)
            except Exception as e:
                raise PrecompileError(self._wl.kind, sel, e) from e
        return len(sels)

    def __call__(self, *args, lazy: bool = False):
        """Dynamic-shape dispatch through the masked-tail staging contract.

        Select on the runtime extent, then make ONE launch of the bucket's
        executable:

          * bucket-aligned extent — the call args are the inputs directly:
            zero copies, one launch;
          * unaligned extent — dynamic args are copied in place into
            engine-owned bucket buffers (O(true-size) writes, no allocation,
            no zero fill; the pad tail keeps stale bytes the kernel masks),
            then one launch, then the output slice back to the true extent.

        The returned tensor is the launch's own fresh output (or a view of
        it), never an engine buffer, so a caller may mutate it freely.

        :class:`LazyBucket` operands at positions the workload declares in
        ``consumes_staged`` forward their bucket buffer into the launch
        (``_call_forwarded``): no unstage of the producer, no restage here
        when the buckets agree.  Handles at any other position realize
        first (one counted slice).  With ``lazy=True`` the output comes
        back as a LazyBucket instead of being finalized -- best-effort:
        the zero-pad reference path (staging off) and workloads without a
        bucket-shaped output return plain tensors, so chain callers accept
        both.  A call of plain tensors pays one type scan for all this.

        A candidate that raises at build or launch walks the degradation
        ladder (``_degrade``): the call still returns a correct result
        whenever any rung works.
        """
        if lazy or LazyBucket in map(type, args):
            return self._call_lazy(args, lazy)
        m = self._wl.dynamic_extent(*args)
        sel = self._select_healthy(m)
        try:
            return self._dispatch(sel, m, args)
        except _NOT_A_CANDIDATE:
            raise
        except Exception as exc:
            return self._degrade(m, sel, args, False, exc)

    def _call_lazy(self, args: tuple, lazy: bool):
        """``__call__`` for handle operands or a ``lazy`` output."""
        wl = self._wl
        if LazyBucket in map(type, args):
            fwd = wl.consumes_staged if self._staging else {}
            args = tuple(
                a.realize()
                if isinstance(a, LazyBucket) and i not in fwd else a
                for i, a in enumerate(args)
            )
            handles = {
                i for i, a in enumerate(args) if isinstance(a, LazyBucket)
            }
            if handles:
                return self._call_forwarded(args, handles, lazy)
        m = wl.dynamic_extent(*args)
        sel = self._select_healthy(m)
        try:
            return self._dispatch(sel, m, args, lazy)
        except _NOT_A_CANDIDATE:
            raise
        except Exception as exc:
            return self._degrade(m, sel, args, lazy, exc)

    def _dispatch(self, sel: Selection, m: int, args: tuple,
                  lazy: bool = False):
        """One dispatch attempt at a fixed Selection (a ladder rung)."""
        wl = self._wl
        entry = self._entry_for(sel, args)
        st = self.dispatch_stats
        view = wl.stage_view(*args)
        if not self._staging:
            with self._stats_lock:
                st.calls += 1
            return self._call_padded(sel, entry, args, view)
        lazy_out = lazy and wl.staged_out_axis is not None
        scalars = wl.runtime_scalars(sel, *view)
        shapes = wl.staged_shapes(sel, *view)
        unaligned = [
            i for i, s in enumerate(shapes)
            if s is not None and tuple(view[i].shape) != s
        ]
        if not unaligned:
            with self._stats_lock:
                st.calls += 1
                st.aligned_calls += 1
                st.launches += 1
            out = entry.run(*view, *scalars)
            if lazy_out:
                return LazyBucket(out, m, wl.staged_out_axis, st,
                                  self._stats_lock)
            return wl.finalize(sel, out, *args)
        device = view[unaligned[0]].device
        stream = _stream_key(device)
        need = tuple((i, shapes[i], view[i].dtype) for i in unaligned)
        bufs = entry.pool.acquire(need, device, stream)
        bufs.stage(unaligned, [view[i] for i in unaligned], stream)
        staged = list(view)
        for i in unaligned:
            staged[i] = bufs[i]
        with self._stats_lock:
            st.calls += 1
            st.unaligned_calls += 1
            st.stage_copies += len(unaligned)
            st.launches += 1
            # A lazy output defers the unstage slice: it is only paid (and
            # counted, as realize_slices) if a non-engine consumer forces
            # the handle.
            if wl.unstages and not lazy_out:
                st.unstage_copies += 1
        try:
            out = entry.run(*staged, *scalars)
        finally:
            # The launch that reads the set is enqueued on this stream; the
            # pool hands the set only to callers on the same stream.  A
            # launch that raises (a ladder rung) settles the set too.
            entry.pool.release(bufs, device, stream)
        if lazy_out:
            return LazyBucket(out, m, wl.staged_out_axis, st,
                              self._stats_lock)
        return wl.finalize(sel, out, *args)

    # -- degradation ladder (DESIGN.md §11) ---------------------------------

    @staticmethod
    def _qkey(sel: Selection) -> str:
        """The quarantine identity of a candidate: what failed is the
        (bucket, backend, tiling) triple -- the executable the lattice
        produced -- not the runtime extent that happened to trigger it."""
        return repr((sel.bucket, sel.backend, sel.strategy.tiles))

    def _select_healthy(self, m: int) -> Selection:
        """The table/argmin selection, skipping quarantined candidates.
        The quarantine set is empty on every healthy host, so the hot path
        pays one falsy check on top of the plain ``select``."""
        sel = self.selector.select(m)
        q = self._quarantined
        if q and self._qkey(sel) in q:
            healthy = self.selector.select_excluding(m, q, self._qkey)
            if healthy is not None:
                return healthy
        return sel

    def _quarantine(self, sel: Selection) -> bool:
        """Quarantine ``sel``; True if it was not already quarantined.
        The check and the add are one step, so two threads failing on one
        candidate count it once."""
        key = self._qkey(sel)
        with self._stats_lock:
            if key in self._quarantined:
                return False
            self._quarantined.add(key)
            self.dispatch_stats.quarantined += 1
        return True

    def _unquarantine(self, fresh: list[Selection]) -> None:
        """Roll back this call's quarantines (``fresh``)."""
        with self._stats_lock:
            self.dispatch_stats.quarantined -= len(fresh)
            for t in fresh:
                self._quarantined.discard(self._qkey(t))

    def _degrade(
        self, m: int, sel: Selection, args: tuple, lazy: bool,
        exc: Exception,
    ):
        """Walk the ladder after ``sel`` failed: quarantine it, re-select
        the next-best lattice candidate excluding quarantined entries,
        retry up to ``max_retries``, then, for CPU operands only, run the
        ``impl="torch"`` rung.

        Quarantine keys are persisted to the denylist only once a LOWER
        rung succeeds -- evidence the failure was candidate-specific rather
        than a caller error that every candidate would reproduce.  If the
        last rung fails too, this call's quarantines are rolled back and
        the last rung's exception propagates from the original one:
        nothing was learned about the candidates.  On the card the last
        rung is the last hand-written candidate: when it fails, the
        quarantines are rolled back likewise and
        :class:`LadderExhaustedError` propagates from the last failure.
        A :class:`KernelLibraryError` or an ``OperandError`` on a retry
        rolls back too and propagates as it is.
        """
        fresh = [sel] if self._quarantine(sel) else []
        for _ in range(self._max_retries):
            nxt = self.selector.select_excluding(
                m, self._quarantined, self._qkey
            )
            if nxt is None:
                break  # lattice exhausted: straight to the last rung
            try:
                out = self._dispatch(nxt, m, args, lazy)
            except _NOT_A_CANDIDATE:
                self._unquarantine(fresh)
                raise
            except Exception as e:
                exc = e
                if self._quarantine(nxt):
                    fresh.append(nxt)
                continue
            self._persist_quarantines(fresh)
            return out
        if _on_card(args):
            self._unquarantine(fresh)
            raise LadderExhaustedError(
                f"{self._wl.kind}: every hand-written candidate the ladder "
                f"tried (at most 1 + {self._max_retries}) failed at build "
                f"or launch; operands on the card have no plain-version "
                f"rung") from exc
        try:
            out = self._fallback_dispatch(m, args)
        except Exception as e:
            self._unquarantine(fresh)
            raise e from exc
        self._persist_quarantines(fresh)
        return out

    def _persist_quarantines(self, fresh: list[Selection]) -> None:
        if self._denylist is None:
            return
        for t in fresh:
            self._denylist.add(self._sig_key, self._qkey(t))

    def _fallback_dispatch(self, m: int, args: tuple):
        """The last rung for CPU operands: the plain PyTorch versions
        (``impl="torch"``) at the analytical selection's bucket, through
        the zero-pad reference path.  No staging buffers -- nothing the
        failing rungs shared -- and no fault hook, so chaos plans cannot
        reach it."""
        wl = self._wl
        sel = self.selector.select(m)
        key = (
            "__torch_fallback__", sel.bucket, sel.strategy.l1,
            wl.exec_key(*args) if args else (),
        )
        entry = self._exec_cache.get(key)
        if entry is None:
            entry = _CacheEntry(
                fn=wl.build_executable(sel, impl="torch"),
                compile_seconds=0.0, pool=None)
            self._exec_cache[key] = entry
        entry.hits += 1
        with self._stats_lock:
            self.dispatch_stats.calls += 1
            self.dispatch_stats.fallbacks += 1
        return self._call_padded(sel, entry, args, wl.stage_view(*args))

    def _call_forwarded(self, args: tuple, handles: set, lazy: bool):
        """Bucket-to-bucket dispatch: LazyBucket operands hand their raw
        bucket buffers to the launch, the true extents ride in the runtime
        scalars.  Selection happens at the PADDED extent (the buffers' own
        bucket), so a producer and consumer sharing a bucket forward with
        zero copies; a handle whose buffer does not match this selection's
        staged shape restages (counted stage copy) -- correct either way,
        because staged tails are garbage by contract and every mask scalar
        is computed from the TRUE shapes (which the handles report).

        Forwarding is eager-only: inside a CUDA graph capture every handle
        realizes and the call takes the plain path.  ``consumes_staged``
        positions are call-arg positions; only identity-``stage_view``
        workloads declare any, so view index == arg index throughout.

        The selection skips quarantined candidates (``_select_healthy``;
        the reference's selects plainly, ROADMAP C9); a forwarded call does
        not walk the ladder, as in the reference.
        """
        wl = self._wl
        st = self.dispatch_stats

        def realize_all():
            flat = tuple(
                a.realize() if isinstance(a, LazyBucket) else a for a in args
            )
            return self(*flat, lazy=lazy)

        raw = tuple(
            a.buffer if isinstance(a, LazyBucket) else a for a in args
        )
        if args[min(handles)].device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            return realize_all()
        view = wl.stage_view(*raw)
        try:
            m_disp = wl.dynamic_extent(*raw)
            m_true = wl.dynamic_extent(*args)
        except ValueError:
            # Mixed handle/plain operands whose padded vs true extents the
            # workload refuses to reconcile (attention's q/kv seq match).
            return realize_all()
        sel = self._select_healthy(m_disp)
        entry = self._entry_for(sel, raw)
        scalars = wl.runtime_scalars(sel, *wl.stage_view(*args))
        shapes = wl.staged_shapes(sel, *view)
        unaligned = [
            i for i, s in enumerate(shapes)
            if s is not None and tuple(view[i].shape) != s
        ]
        lazy_out = lazy and wl.staged_out_axis is not None
        slices_out = (
            wl.unstages and not lazy_out and wl.dynamic_bucket(sel) != m_true
        )
        if not unaligned:
            with self._stats_lock:
                st.calls += 1
                st.aligned_calls += 1
                st.launches += 1
                st.forwarded += len(handles)
                if slices_out:
                    st.unstage_copies += 1
            out = entry.run(*view, *scalars)
        else:
            device = view[unaligned[0]].device
            stream = _stream_key(device)
            need = tuple((i, shapes[i], view[i].dtype) for i in unaligned)
            bufs = entry.pool.acquire(need, device, stream)
            # Restaging a handle writes its WHOLE buffer -- garbage tail
            # included -- into the larger bucket; safe, since the scalars
            # above mask at the true extents.
            bufs.stage(unaligned, [view[i] for i in unaligned], stream)
            staged = list(view)
            for i in unaligned:
                staged[i] = bufs[i]
            with self._stats_lock:
                st.calls += 1
                st.unaligned_calls += 1
                st.stage_copies += len(unaligned)
                st.launches += 1
                st.forwarded += len(handles - set(unaligned))
                if slices_out:
                    st.unstage_copies += 1
            try:
                out = entry.run(*staged, *scalars)
            finally:
                entry.pool.release(bufs, device, stream)
        if lazy_out:
            return LazyBucket(out, m_true, wl.staged_out_axis, st,
                              self._stats_lock)
        return wl.finalize(sel, out, *args)

    def add_dispatch_stats(self, delta: dict[str, int]) -> None:
        """Add ``delta`` (field -> count, as two ``dispatch_stats.as_dict()``
        readings differ) to the DispatchStats: a CUDA graph's replay runs
        the launches its capture counted without this dispatch running."""
        st = self.dispatch_stats
        with self._stats_lock:
            for name, n in delta.items():
                setattr(st, name, getattr(st, name) + n)

    def staging_sets(self) -> list[_BufferSet]:
        """Every pooled staging-buffer set of every executable entry."""
        return [s for e in list(self._exec_cache.values())
                if e.pool is not None for s in e.pool.retained]

    def _call_padded(self, sel, entry, args, view) -> torch.Tensor:
        """The zero-pad reference path: the same executable and extent
        scalars, with fresh zero-padded tensors instead of engine buffers.
        ``view`` is ``stage_view(*args)``; ``finalize`` gets the raw args."""
        wl = self._wl
        st = self.dispatch_stats
        scalars = wl.runtime_scalars(sel, *view)
        shapes = wl.staged_shapes(sel, *view)
        aligned = all(
            s is None or tuple(view[i].shape) == s
            for i, s in enumerate(shapes)
        )
        if aligned:
            out = entry.fn(*view, *scalars)
        else:
            with self._stats_lock:
                st.padded_calls += 1
            out = entry.fn(*wl.prepare(sel, *view), *scalars)
        return wl.finalize(sel, out, *args)

    def call_padded(self, *args) -> torch.Tensor:
        """Public reference dispatch: the padded path end to end (select,
        zero-pad prepare, executable, finalize).  The staged hot path must
        be bit-identical to this."""
        wl = self._wl
        sel = self.selector.select(wl.dynamic_extent(*args))
        entry = self._entry_for(sel, args)
        with self._stats_lock:
            self.dispatch_stats.calls += 1
        return self._call_padded(sel, entry, args, wl.stage_view(*args))

    @property
    def cache_info(self) -> dict:
        return {
            "entries": len(self._exec_cache),
            "hits": sum(e.hits for e in self._exec_cache.values()),
            "compile_seconds": sum(
                e.compile_seconds for e in self._exec_cache.values()
            ),
        }

    @property
    def select_stats(self) -> dict:
        s = self.selector.stats
        return {
            "selects": s.selects,
            "table_hits": s.table_hits,
            "lru_hits": s.lru_hits,
            "argmin_misses": s.argmin_misses,
            "cache_hits": s.cache_hits,
            "mean_select_us": s.mean_select_us,
            "table_builds": s.table_builds,
            "table_build_seconds": s.table_build_seconds,
            "calibration_seconds": s.calibration_seconds,
            "table_swaps": s.table_swaps,
        }


def __getattr__(name: str):
    # The deprecation shims live with the public API (vortex/compat.py)
    # and stay importable from their historical home; the import is
    # deferred so core never pulls vortex at import time.
    if name in ("VortexEngine", "VortexGemm"):
        from repro_torch.vortex import compat

        return getattr(compat, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
