"""Engine: a session over many workloads, served from one cache hierarchy.

One Engine = one :class:`~repro_torch.vortex.config.EngineConfig` + one
scored-lattice cache + one compiled-kernel table + one raw-tuple dispatch
table.  It has NO per-operator entry points: every registered workload kind
(``@register_workload``) is reachable through :meth:`compile` /
:meth:`dispatch` — and therefore through ``vortex.ops.<kind>``.

Engines are installed per-context with :func:`repro_torch.vortex.use`
(contextvar scoped: nestable, exception-safe, thread-isolated); model
layers and ops pick up the innermost installed engine.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any

from repro_torch.core.analyzer import (
    Profiler,
    ScoredLattice,
    TableProfiler,
    WallClockProfiler,
)
from repro_torch.core.engine import VortexKernel
from repro_torch.core.hardware import get_hardware
from repro_torch.core.workloads import WORKLOADS, Workload, make_workload
from repro_torch.vortex.config import EngineConfig
from repro_torch.vortex.handle import CompiledOp

__all__ = ["Engine", "pow2_bucket"]


def pow2_bucket(n: int) -> int:
    """Power-of-two bucket for auxiliary outer dims (serving batch size):
    dims that merely multiply the lattice-bucketed extent are quantized to
    pow2 so the executable cache stays small with <= 2x waste."""
    p = 1
    while p < n:
        p *= 2
    return p


class Engine:
    """A scoped compilation/serving session over the workload registry.

    ``config`` may be an :class:`EngineConfig`, a hardware name string, or
    None (defaults: the H100 lattice on the card); keyword ``overrides``
    replace individual config fields either way.  First use of a new
    signature builds its lattice once; every runtime extent is then served
    from the same scored lattice (sample-free).  Workloads whose lattice
    inputs coincide share scored lattices through one engine-wide cache.
    """

    def __init__(
        self,
        config: EngineConfig | str | None = None,
        *,
        profiler: Profiler | None = None,
        **overrides: Any,
    ):
        if config is None:
            config = EngineConfig(**overrides)
        else:
            if isinstance(config, str):
                config = EngineConfig(hardware=config, **overrides)
            elif overrides:
                config = dataclasses.replace(config, **overrides)
        self.config = config
        self._hw = get_hardware(config.hardware)
        if profiler is None:
            profiler = (
                WallClockProfiler(config.device)
                if config.hardware == "host_cpu"
                else TableProfiler(self._hw)
            )
        self._profiler = profiler
        # Paper defaults (Table 7): E:L0 on CPU; E:L0,L1 on GPU-class HW.
        self._empirical_levels = (
            config.empirical_levels
            if config.empirical_levels is not None
            else (0,) if config.hardware == "host_cpu" else (0, 1)
        )
        # Eq. 3's |HardwareUnit| at the grid level: 132 SMs on the H100,
        # 1 on the reference's TPU v5e and host CPU specs.
        self._num_cores = self._hw.level(self._hw.num_levels - 1).parallel_units
        self._kernels: dict[tuple, VortexKernel] = {}
        self._scored_cache: dict[tuple, ScoredLattice] = {}
        # Zero-rebuild hot path: raw call-site tuples -> compiled kernel.
        self._dispatch: dict[tuple, VortexKernel] = {}
        # Kernel builds are expensive (lattice sweep); serialize them so two
        # threads first touching the same signature don't build it twice.
        self._build_lock = threading.Lock()
        # Background calibrator (core/calibrate.py), created on first use
        # when config.calibration != "off".  Guarded by _build_lock.
        self._calibrator = None

    @property
    def calibrator(self):
        """The background :class:`~repro_torch.core.calibrate.Calibrator`
        for this engine's kernels: None when ``config.calibration ==
        "off"`` (the default), in which case nothing calibration-related
        is ever constructed and dispatch is the analytical engine's."""
        cfg = self.config
        if cfg.calibration == "off":
            return None
        if self._calibrator is None:
            with self._build_lock:
                if self._calibrator is None:
                    from repro_torch.core.calibrate import (
                        CalibrationPolicy,
                        Calibrator,
                    )

                    self._calibrator = Calibrator(
                        lambda: list(self._kernels.values()),
                        CalibrationPolicy(
                            mode=cfg.calibration,
                            top_k=cfg.calibration_top_k,
                            budget_s=cfg.calibration_budget_s,
                            cache_dir=cfg.calibration_cache_dir,
                        ),
                        device=cfg.device,
                    )
        return self._calibrator

    @property
    def hardware(self):
        return self._hw

    @property
    def device(self) -> str:
        return self.config.device

    # -- session scoping ----------------------------------------------------

    def use(self):
        """Install this engine for the current context: shorthand for
        ``vortex.use(engine)``."""
        from repro_torch.vortex.session import use

        return use(self)

    def kernels(self) -> dict[tuple, VortexKernel]:
        """A snapshot of the compiled kernels, by workload signature."""
        return dict(self._kernels)

    # -- workload plumbing --------------------------------------------------

    def kernel_for(self, wl: Workload) -> VortexKernel:
        """The compiled kernel serving ``wl``'s signature (built lazily)."""
        key = wl.signature
        kern = self._kernels.get(key)
        built = False
        if kern is None:
            with self._build_lock:
                kern = self._kernels.get(key)
                if kern is None:
                    built = True
                    cfg = self.config
                    kern = VortexKernel(
                        self._hw,
                        wl,
                        profiler=self._profiler,
                        empirical_levels=self._empirical_levels,
                        backends=cfg.backends,
                        num_cores=self._num_cores,
                        impl=cfg.impl,
                        scored_cache=self._scored_cache,
                        table_m_max=cfg.table_m_max,
                        table_extend_limit=cfg.table_extend_limit,
                        staging=cfg.staging,
                        staging_pool_cap=cfg.staging_pool_cap,
                    )
                    self._kernels[key] = kern
        if built and self.config.calibration == "eager-warmup":
            # Warm at build time: persisted tables load by hardware
            # fingerprint (zero re-measurements on restart); anything not
            # on disk is measured now, before serving.
            cal = self.calibrator
            cal.load()
            if cal.pending():
                cal.run()
        return kern

    def compile(
        self, workload: Workload | str, **params: Any
    ) -> CompiledOp:
        """The CompiledOp handle for a workload signature (a Workload
        instance, or a registered kind name with its parameters).

        With ``config.precompile_m_max > 0`` a newly built op's executable
        buckets are warmed eagerly (workloads without outer-dim
        specialization only; the rest need representative args, see
        CompiledOp.precompile)."""
        if isinstance(workload, str):
            workload = make_workload(workload, **params)
        elif params:
            raise TypeError(
                "workload parameters are only accepted with a kind name, "
                f"not alongside a Workload instance: {sorted(params)}"
            )
        known = workload.signature in self._kernels
        op = CompiledOp(self, self.kernel_for(workload))
        pm = self.config.precompile_m_max
        if pm > 0 and not known and not self._exec_specialized(workload):
            op.precompile(pm)
        return op

    @staticmethod
    def _exec_specialized(wl: Workload) -> bool:
        """True when ``wl``'s executables key on outer dims of the call
        args (overridden ``exec_key``): eager precompile without
        representative args would warm keys real calls never hit."""
        return type(wl).exec_key is not Workload.exec_key

    # -- registry-driven dispatch -------------------------------------------

    def op_kernel(self, kind: str, args: tuple, kwargs: dict) -> VortexKernel:
        """Resolve a call site to its compiled kernel through the registry:
        raw-tuple lookup on the hot path, Workload.bind on first use."""
        cls = WORKLOADS[kind]
        dkey = cls.dispatch_key(*args, **kwargs)
        if dkey is None:
            return self.kernel_for(cls.bind(*args, **kwargs))
        key = (kind,) + dkey
        kern = self._dispatch.get(key)
        if kern is None:
            kern = self.kernel_for(cls.bind(*args, **kwargs))
            self._dispatch[key] = kern
        return kern

    def dispatch(self, kind: str, *args: Any, **kwargs: Any):
        """Serve one call of a registered workload kind: ``args`` are the
        runtime tensors, ``kwargs`` the workload parameters.  This is what
        ``vortex.ops.<kind>(...)`` invokes."""
        return self.op_kernel(kind, args, kwargs)(*args)

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict[str, dict]:
        """Per-workload-kind serving stats: selection overhead, executable
        cache behaviour and the hot-path DispatchStats, plus the
        engine-level ``calibration`` section (not a kind: iterating kinds
        must skip it)."""
        out: dict[str, dict] = {}
        for kernel in list(self._kernels.values()):  # snapshot (threads)
            kind = kernel.workload.kind
            agg = out.setdefault(
                kind,
                {
                    "signatures": 0, "selects": 0, "select_table_hits": 0,
                    "select_lru_hits": 0, "select_argmin_misses": 0,
                    "select_cache_hits": 0, "select_us_sum": 0.0,
                    "table_entries": 0, "table_build_s": 0.0,
                    "calibration_seconds": 0.0, "table_swaps": 0,
                    "exec_entries": 0, "exec_hits": 0,
                    "compile_seconds": 0.0,
                    **{k: 0 for k in kernel.dispatch_stats.as_dict()},
                },
            )
            sstats = kernel.selector.stats
            cinfo = kernel.cache_info
            table = kernel.selector.table_if_built
            agg["signatures"] += 1
            agg["selects"] += sstats.selects
            agg["select_table_hits"] += sstats.table_hits
            agg["select_lru_hits"] += sstats.lru_hits
            agg["select_argmin_misses"] += sstats.argmin_misses
            agg["select_cache_hits"] += sstats.cache_hits
            agg["select_us_sum"] += sstats.select_seconds * 1e6
            agg["table_entries"] += len(table) if table is not None else 0
            agg["table_build_s"] += sstats.table_build_seconds
            agg["calibration_seconds"] += sstats.calibration_seconds
            agg["table_swaps"] += sstats.table_swaps
            agg["exec_entries"] += cinfo["entries"]
            agg["exec_hits"] += cinfo["hits"]
            agg["compile_seconds"] += cinfo["compile_seconds"]
            for key, val in kernel.dispatch_stats.as_dict().items():
                agg[key] += val
        cal = self.calibrator  # lazily constructs when calibration is on
        out["calibration"] = (
            cal.stats() if cal is not None
            else {"enabled": False, "mode": "off"}
        )
        return out

    def __repr__(self) -> str:
        return (
            f"Engine({self.config!r}, kernels={len(self._kernels)}, "
            f"dispatch_keys={len(self._dispatch)})"
        )
