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
