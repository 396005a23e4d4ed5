"""Vortex core: hardware-driven, sample-free dynamic-shape tensor-program
optimization (the paper's contribution), ported for the H100."""
from repro_torch.core.analyzer import (
    AnalyticalProfiler,
    HybridAnalyzer,
    Profiler,
    ScoredLattice,
    StackedLattices,
    TableProfiler,
    WallClockProfiler,
)
from repro_torch.core.candidates import CandidateLattice, generate_lattice
from repro_torch.core.engine import (
    DispatchStats,
    OfflineStats,
    PrecompileError,
    VortexKernel,
)
from repro_torch.core.hardware import (
    H100_SXM,
    HOST_CPU,
    TPU_V5E,
    HardwareSpec,
    get_hardware,
)
from repro_torch.core.rkernel import RKernelProgram, Strategy
from repro_torch.core.selection_table import SelectionTable
from repro_torch.core.selector import RuntimeSelector, Selection, SelectorStats
from repro_torch.core.workloads import (
    WORKLOADS,
    AttentionWorkload,
    Conv2dWorkload,
    DecodeAttentionWorkload,
    GemmWorkload,
    GroupedGemmWorkload,
    SelectionDeviationError,
    Workload,
    make_workload,
    register_workload,
)

__all__ = [n for n in dir() if not n.startswith("_")] + [
    "VortexEngine",
    "VortexGemm",
]

_LAZY_SHIMS = ("VortexEngine", "VortexGemm")


def __getattr__(name: str):
    # The deprecation shims resolve lazily (PEP 562), so importing
    # repro_torch.core never pulls repro_torch.vortex, which imports core
    # modules.  `from repro_torch.core import VortexEngine` still works.
    if name in _LAZY_SHIMS:
        from repro_torch.core import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
