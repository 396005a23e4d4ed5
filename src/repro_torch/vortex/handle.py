"""CompiledOp: the one generic handle every workload kind is served by.

``vortex.compile(workload)`` returns a CompiledOp; ``vortex.ops.<kind>``
routes through one per call-site signature.  The handle is a thin, stable
facade over :class:`repro_torch.core.engine.VortexKernel` — callers hold ONE
object with ``__call__`` / ``precompile`` / ``select`` / ``stats`` and
never touch engine internals, so new workload kinds and future multi-device
kernels slot in behind it without API changes.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.core.engine import VortexKernel
from repro_torch.core.selector import Selection
from repro_torch.core.workloads import Workload

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.vortex.engine import Engine

__all__ = ["CompiledOp"]


class CompiledOp:
    """One workload signature, compiled sample-free, bound to an engine.

    * ``op(*args)``             — dynamic-shape dispatch (select → bucket →
                                  cached executable → unpad),
    * ``op.select(m)``          — the Selection the engine would serve at
                                  extent ``m`` (strategy, backend, bucket),
    * ``op.bucket(m)``          — the padded dynamic extent at ``m`` (what
                                  serving layers quantize to),
    * ``op.buckets(m_max)``     — every distinct bucket reachable up to
                                  ``m_max`` (from the lattice breakpoints,
                                  not from shape samples),
    * ``op.precompile(m_max)``  — warm every reachable executable,
    * ``op.stats()``            — selection + executable-cache accounting.
    """

    __slots__ = ("_engine", "_kernel")

    def __init__(self, engine: "Engine", kernel: VortexKernel):
        self._engine = engine
        self._kernel = kernel

    # -- identity -----------------------------------------------------------

    @property
    def engine(self) -> "Engine":
        return self._engine

    @property
    def kernel(self) -> VortexKernel:
        """The underlying compiled kernel (selector + executable cache)."""
        return self._kernel

    @property
    def workload(self) -> Workload:
        return self._kernel.workload

    @property
    def kind(self) -> str:
        return self._kernel.workload.kind

    # -- serving ------------------------------------------------------------

    def __call__(self, *args, lazy: bool = False):
        return self._kernel(*args, lazy=lazy)

    def select(self, m: int) -> Selection:
        return self._kernel.select(m)

    def bucket(self, m: int) -> int:
        """The padded dynamic extent an extent of ``m`` is served at
        (``Workload.dynamic_bucket`` of the Selection: padded_m for
        GEMM-view workloads, the kv bucket for decode attention)."""
        sel = self._kernel.select(max(m, 1))
        return self._kernel.workload.dynamic_bucket(sel)

    def buckets(self, m_max: int) -> list[int]:
        """All distinct padded extents reachable for m in [1, m_max]."""
        return self._kernel.selector.buckets_upto(m_max)

    def precompile(self, m_max: int, *args) -> int:
        """Warm every executable bucket reachable up to ``m_max``; pass
        representative ``args`` for workloads whose executables specialize
        on outer dims (attention: any q/k/v with the serving batch/head
        layout).  Raises :class:`repro_torch.core.engine.PrecompileError` naming
        the failing Selection if a bucket does not build."""
        return self._kernel.precompile(m_max, *args)

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Selection-path, executable-cache and hot-path copy/launch
        accounting for this op.  ``dispatch`` carries the padding-free
        contract's observables: launches per call, staging/unstaging copies
        for unaligned extents, how many calls fell back to the zero-pad
        reference path (``padded_calls`` — 0 in steady-state serving), and
        the lazy-handle chain counters — ``forwarded`` (LazyBucket operands
        consumed bucket-to-bucket, no boundary copy) and ``realize_slices``
        (deferred output slices forced by non-engine consumers)."""
        k = self._kernel
        return {
            "kind": self.kind,
            "signature": self.workload.signature,
            "select": k.select_stats,
            "exec": k.cache_info,
            "dispatch": k.dispatch_stats.as_dict(),
            "offline": k.offline_stats,
        }

    def __repr__(self) -> str:
        return (
            f"CompiledOp(kind={self.kind!r}, "
            f"signature={self.workload.signature!r})"
        )
