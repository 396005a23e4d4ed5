"""repro_torch.vortex — the public API over the sample-free pipeline.

* **Handles** — :func:`compile` returns a :class:`CompiledOp`: one generic
  object per workload signature with ``__call__`` / ``precompile`` /
  ``select`` / ``bucket`` / ``stats``.
* **Registry-driven ops** — :mod:`vortex.ops` exposes every
  ``@register_workload`` kind as ``vortex.ops.<kind>``.
* **Sessions** — an :class:`Engine` (configured by the frozen
  :class:`EngineConfig`) is installed per-context with :func:`use`.

Quickstart (on the card)::

    from repro_torch import vortex

    y = vortex.ops.gemm(a, b)                  # default session: H100 lattice
    with vortex.use(vortex.Engine(device="cpu", hardware="tpu_v5e")):
        y = vortex.ops.gemm(a_cpu, b_cpu)      # plain versions on the CPU
"""
from __future__ import annotations

from repro_torch.core.engine import LazyBucket, lazy_map  # noqa: F401
from repro_torch.core.workloads import (  # noqa: F401
    WORKLOADS,
    Workload,
    make_workload,
    register_workload,
)
from repro_torch.vortex import ops  # noqa: F401
from repro_torch.vortex.config import EngineConfig  # noqa: F401
from repro_torch.vortex.engine import Engine, pow2_bucket  # noqa: F401
from repro_torch.vortex.handle import CompiledOp  # noqa: F401
from repro_torch.vortex.session import (  # noqa: F401
    current_engine,
    default_engine,
    installed_engine,
    use,
)

__all__ = [
    "CompiledOp",
    "Engine",
    "EngineConfig",
    "LazyBucket",
    "WORKLOADS",
    "Workload",
    "compile",
    "current_engine",
    "default_engine",
    "installed_engine",
    "lazy_map",
    "make_workload",
    "ops",
    "pow2_bucket",
    "register_workload",
    "use",
]


def compile(
    workload: "Workload | str",
    *,
    engine: "Engine | None" = None,
    **params,
) -> "CompiledOp":
    """Compile a workload signature on the ambient (or given) session::

        op = vortex.compile("gemm", M=None, N=768, K=768)
    """
    eng = engine if engine is not None else current_engine()
    return eng.compile(workload, **params)
