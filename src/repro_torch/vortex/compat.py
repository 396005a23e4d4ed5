"""Deprecation shims for the pre-``vortex`` public surface (counterpart of
src/repro/vortex/compat.py).

Importable from their historical home (``repro_torch.core`` and
``repro_torch.core.engine`` re-export them through a module
``__getattr__``).  The shims are thin: they delegate to exactly the
registry-driven machinery the new API uses, so outputs are bit-identical
and the dispatch, kernel and executable cache keys are the same; a caller
migrating call site by call site never builds a kernel twice.  Each warns
with :class:`VortexDeprecationWarning`.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.analyzer import Profiler
from repro_torch.core.engine import VortexKernel
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.workloads import GemmWorkload, Workload
from repro_torch.vortex._deprecation import warn_deprecated
from repro_torch.vortex.config import EngineConfig
from repro_torch.vortex.engine import Engine

__all__ = ["VortexEngine", "VortexGemm"]


class VortexEngine(Engine):
    """Deprecated per-operator face of :class:`repro_torch.vortex.Engine`.

    The engine itself lives on; what is deprecated is the one-method-per-
    kind surface (``gemm``/``attention``/``conv2d``): use
    ``vortex.ops.<kind>`` / ``engine.dispatch(kind, ...)``.  The
    reference's ``num_cores`` and ``interpret`` have no counterpart (the
    hardware spec gives the cores, the operands' device the kernel); the
    port's ``device`` takes their place, the card by default.
    """

    def __init__(
        self,
        hardware: str = "h100_sxm",
        profiler: Profiler | None = None,
        empirical_levels: tuple[int, ...] | None = None,
        backends: tuple[str, ...] | None = None,
        impl: str | None = None,
        device: str = "cuda",
    ):
        super().__init__(
            EngineConfig(
                hardware=hardware,
                backends=backends,
                impl=impl,
                device=device,
                empirical_levels=empirical_levels,
            ),
            profiler=profiler,
        )

    # -- deprecated per-op entry points ------------------------------------

    def gemm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """C[M,N] = A[M,K] @ B[K,N] with dynamic M."""
        warn_deprecated("VortexEngine.gemm", "vortex.ops.gemm")
        return self.dispatch("gemm", a, b)

    def attention(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        *,
        causal: bool = True,
        window: int | None = None,
        softcap: float | None = None,
    ) -> torch.Tensor:
        """Flash attention with dynamic sequence length."""
        warn_deprecated("VortexEngine.attention", "vortex.ops.attention")
        return self.dispatch(
            "attention", q, k, v, causal=causal, window=window,
            softcap=softcap,
        )

    def conv2d(
        self, x: torch.Tensor, w: torch.Tensor, *, stride: int = 1
    ) -> torch.Tensor:
        """Conv2D (VALID): x (b, h, w, cin); w (kh, kw, cin, cout)."""
        warn_deprecated("VortexEngine.conv2d", "vortex.ops.conv2d")
        return self.dispatch("conv2d", x, w, stride=stride)

    def gemm_for(self, n: int, k: int) -> VortexKernel:
        warn_deprecated(
            "VortexEngine.gemm_for", 'engine.compile("gemm", ...).kernel'
        )
        return self.kernel_for(GemmWorkload(M=None, N=n, K=k))


class VortexGemm(VortexKernel):
    """Deprecated name for a GEMM-bound :class:`VortexKernel`: exactly
    VortexKernel over a GemmWorkload, kept so old GEMM-only callers keep
    importing; new code uses ``vortex.compile(GemmWorkload(...))``."""

    def __init__(self, hw: HardwareSpec, wl: Workload, *args: Any, **kw: Any):
        warn_deprecated(
            "VortexGemm", "vortex.compile(GemmWorkload(...)) or VortexKernel"
        )
        super().__init__(hw, wl, *args, **kw)
