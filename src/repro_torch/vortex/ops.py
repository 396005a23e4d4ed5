"""``vortex.ops``: one callable per registered workload kind — generated
from the ``WORKLOADS`` registry, never hand-listed.

``@register_workload`` alone is what exposes an op here: attribute access
resolves kinds against the live registry (PEP 562 module ``__getattr__``),
so a workload registered at any point — including inside a test — is
immediately callable as ``vortex.ops.<kind>`` with NO edits to any engine
module.  Each op routes through the contextvar session::

    from repro_torch import vortex

    y = vortex.ops.gemm(a, b)                    # process-default engine
    with vortex.use(Engine(cfg)):
        y = vortex.ops.attention(q, k, v)        # scoped engine

Positional arguments are the runtime arrays (what the compiled executable
consumes); keyword arguments are workload parameters (masking flags,
strides) — the split ``Workload.bind`` declares.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core.workloads import WORKLOADS
from repro_torch.vortex.handle import CompiledOp
from repro_torch.vortex.session import current_engine

__all__ = ["op"]


class Op:
    """The generic op front for one workload kind, bound to the ambient
    session at call time (NOT at creation: the same ``vortex.ops.gemm``
    object serves whichever engine is installed where it is called)."""

    __slots__ = ("kind",)

    def __init__(self, kind: str):
        self.kind = kind

    def __call__(self, *args: Any, **kwargs: Any):
        return current_engine().dispatch(self.kind, *args, **kwargs)

    def compile(self, **params: Any) -> CompiledOp:
        """Pin a full workload signature of this kind on the current
        engine: ``vortex.ops.gemm.compile(M=None, N=768, K=2304)``."""
        return current_engine().compile(self.kind, **params)

    def __repr__(self) -> str:
        return f"vortex.ops.{self.kind}"


_OPS: dict[str, Op] = {}


def op(kind: str) -> Op:
    """The op front for ``kind`` (must be a registered workload)."""
    front = _OPS.get(kind)
    if front is None:
        if kind not in WORKLOADS:
            raise AttributeError(
                f"no workload kind {kind!r} registered; known: "
                f"{sorted(WORKLOADS)}"
            )
        front = _OPS[kind] = Op(kind)
    return front


def __getattr__(name: str) -> Op:
    if name.startswith("_"):
        raise AttributeError(name)
    return op(name)


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(WORKLOADS))
