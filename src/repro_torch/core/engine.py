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
one launch of the staging kernel (kernels/stage.py).  A kernel that fails
raises: there is no degradation rung in this package yet.
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
from repro_torch.kernels.stage import StagePlan

__all__ = [
    "DispatchStats",
    "OfflineStats",
    "PrecompileError",
    "VortexKernel",
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


@dataclasses.dataclass
class DispatchStats:
    """Per-call accounting for the serving hot path, with the reference's
    fields and meanings.

    ``launches`` counts executions of the ONE per-bucket executable;
    ``stage_copies``/``unstage_copies`` count the O(true-size) boundary
    copies an unaligned extent pays (the in-place copy into an engine
    buffer / the output slice back).  ``padded_calls`` counts calls on the
    zero-pad reference path.  ``traced_calls``, ``forwarded``,
    ``realize_slices``, ``fallbacks`` and ``quarantined`` belong to paths
    this package does not have yet (traced calls, lazy handles, the
    degradation ladder) and stay 0.
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
    pool: _StagingPool
    hits: int = 0

    def run(self, *args):
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
    staging-buffer sets.  :class:`repro_torch.vortex.EngineConfig` threads
    all four through.
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
    ):
        if impl not in ("cuda", "torch"):
            raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
        self._hw = hw
        self._wl = wl
        self._impl = impl
        self._staging = staging
        self._pool_cap = staging_pool_cap
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
        t0 = time.perf_counter()
        fn = self._wl.build_executable(sel, impl=self._impl)
        if self._impl == "cuda":
            from repro_torch.kernels.build import library

            library()  # nvcc at first use; later entries find it built
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

    def __call__(self, *args):
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
        """
        wl = self._wl
        m = wl.dynamic_extent(*args)
        sel = self.selector.select(m)
        return self._dispatch(sel, args)

    def _dispatch(self, sel: Selection, args: tuple):
        wl = self._wl
        entry = self._entry_for(sel, args)
        st = self.dispatch_stats
        view = wl.stage_view(*args)
        if not self._staging:
            with self._stats_lock:
                st.calls += 1
            return self._call_padded(sel, entry, args, view)
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
            if wl.unstages:
                st.unstage_copies += 1
        try:
            out = entry.run(*staged, *scalars)
        finally:
            # The launch that reads the set is enqueued on this stream; the
            # pool hands the set only to callers on the same stream.
            entry.pool.release(bufs, device, stream)
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
                for s in e.pool.retained]

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
