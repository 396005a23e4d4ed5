"""Per-device FLOPs, HBM bytes and collective bytes of one step, counted
from the ops it dispatches (the counterpart of
src/repro/roofline/hlo_parse.py, which reads them from XLA's HLO).

The port has no HLO, so :func:`count_costs` runs the step under
:class:`OpCounter`, a ``TorchDispatchMode``, and fills the reference's
:class:`ModuleCosts` with the reference's definitions:

* FLOPs of the products and convolutions (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``mv``, ``dot``, ``convolution`` and its backward):
  2 * output elements * contraction length, as hlo_parse.py's
  ``_dot_flops`` / ``_conv_flops`` count a ``dot`` or a ``convolution``;
* memory bytes: the operands and outputs of those ops and of the
  collectives (hlo_parse.py's ``_op_stream_bytes``), an upper bound on the
  streamed tensors with elementwise traffic folded in;
* collective bytes per kind (all-gather, all-reduce, reduce-scatter,
  all-to-all, collective-permute, broadcast), counted at the op's output
  size.

The numbers are per device, as the reference's SPMD module is the
per-device program.  Over DTensors an op is seen up to three times: as
the global op on DTensors, as DTensor's run of it on fake tensors of its
own to propagate shapes, and as the local op on this rank's shard.  Only
the local op is counted: the counter declines the global one (so DTensor
dispatches it and its local ops come back through the counter) and skips
every op dispatched from DTensor's sharding propagation
(``_sharding_prop.py`` on the Python stack).
A Python loop over the layers dispatches its body once per iteration, so
the counts need no trip-count correction: ``while_trip_counts`` stays
empty.  Gloo and the fake process group run an all-to-all as an
all-gather and a chunk (torch's CPU fallback), and it is counted as the
all-gather it ran as.
"""
from __future__ import annotations

import dataclasses
import sys
from collections import defaultdict
from typing import Any, Callable, Mapping

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    is_traceable_wrapper_subclass,
)
from torch.utils._pytree import tree_flatten

__all__ = ["ModuleCosts", "OpCounter", "count_costs"]

_COLLECTIVES = (
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"), ("send", "collective-permute"),
    ("recv", "collective-permute"), ("broadcast", "broadcast"),
)


@dataclasses.dataclass
class ModuleCosts:
    flops: float
    memory_bytes: float
    collective_bytes: float
    collective_by_kind: Mapping[str, float]
    collective_counts: Mapping[str, int]
    while_trip_counts: Mapping[str, int]

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "memory_bytes": self.memory_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_by_kind": dict(self.collective_by_kind),
            "collective_counts": dict(self.collective_counts),
            "while_trip_counts": dict(self.while_trip_counts),
        }


def _nbytes(x: Any) -> int:
    return sum(t.numel() * t.element_size()
               for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor))


def _shapes(x: Any) -> str:
    return ", ".join(f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"
                     for t in tree_flatten(x)[0]
                     if isinstance(t, torch.Tensor))


def _product_flops(name: str, args: tuple, out: Any) -> float:
    """2 * output elements * contraction length of a product op."""
    if name in ("mm", "bmm", "mv", "dot"):
        a = args[0]
    elif name in ("addmm", "baddbmm", "addmv"):
        a = args[1]
    else:
        return 0.0
    out_elems = out.numel() if name != "dot" else 1
    return 2.0 * out_elems * a.shape[-1]


def _conv_flops(out: torch.Tensor, w: torch.Tensor) -> float:
    # weight (cout, cin / groups, *k): per output element, cin / groups *
    # prod(k) multiply-adds (hlo_parse.py's kernel elems / out features).
    return 2.0 * out.numel() * (w.numel() / max(w.shape[0], 1))


# DTensor runs a global op on fake tensors to propagate its shapes (in its
# own fake mode, or in the caller's when one is active) from this file.
_SHAPE_PROPAGATION = ("torch/distributed/tensor/_sharding_prop.py",
                      "torch\\distributed\\tensor\\_sharding_prop.py")


def _in_shape_propagation() -> bool:
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_filename.endswith(_SHAPE_PROPAGATION):
            return True
        frame = frame.f_back
    return False


class OpCounter(TorchDispatchMode):
    """Counts the products, convolutions and collectives dispatched while
    it is active; read :meth:`costs` after.  ``collectives`` lists each
    collective as ``(kind, output bytes, op name, output shape)``; with
    ``trace=True``, ``trace`` lists every counted op in order as
    ``name(argument shapes) -> output shapes``."""

    def __init__(self, trace: bool = False) -> None:
        super().__init__()
        self.collectives: list[tuple[str, int, str, str]] = []
        self.trace: list[str] | None = [] if trace else None
        self.flops = 0.0
        self.memory = 0.0
        self.coll: dict[str, float] = defaultdict(float)
        self.coll_n: dict[str, int] = defaultdict(int)
        self.op_names: dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if any(is_traceable_wrapper_subclass(x) for x in flat):
            # A wrapper subclass (DTensor): let it run its local ops,
            # which come back through this mode on plain tensors.
            return NotImplemented
        out = func(*args, **kwargs)
        if not _in_shape_propagation():
            self._count(func, args, out)
        return out

    def _count(self, func, args, out) -> None:
        name = func._overloadpacket.__name__
        ns = func.namespace
        self.op_names[f"{ns}.{name}"] += 1
        if self.trace is not None:
            self.trace.append(f"{func}({_shapes(args)}) -> {_shapes(out)}")
        if ns == "aten":
            if name in ("mm", "bmm", "mv", "dot"):
                self.flops += _product_flops(name, args, out)
                self.memory += _nbytes(args[:2]) + _nbytes(out)
            elif name in ("addmm", "baddbmm", "addmv"):
                # The product's operands; the added term is the fused
                # elementwise traffic the reference folds in too.
                self.flops += _product_flops(name, args, out)
                self.memory += _nbytes(args[1:3]) + _nbytes(out)
            elif name == "convolution":
                self.flops += _conv_flops(out, args[1])
                self.memory += _nbytes(args[:2]) + _nbytes(out)
            elif name == "convolution_backward":
                grad_out, w, mask = args[0], args[2], args[-1]
                # grad_input and grad_weight each cost the forward's FLOPs.
                fwd = _conv_flops(grad_out, w)
                self.flops += fwd * (int(mask[0]) + int(mask[1]))
                self.memory += _nbytes(args[:3]) + _nbytes(out)
            return
        if ns not in ("_c10d_functional", "c10d", "c10d_functional"):
            return
        if name.startswith("wait") or name.startswith("_wrap"):
            return
        kind = next((k for key, k in _COLLECTIVES if key in name), None)
        if kind is None:
            return
        # The in-place c10d ops return (tensors, work); their first
        # argument holds the output tensors.
        result = args[0] if ns == "c10d" else out
        nbytes = _nbytes(result)
        self.collectives.append((kind, nbytes, str(func), _shapes(result)))
        self.coll[kind] += nbytes
        self.coll_n[kind] += 1
        self.memory += nbytes

    def costs(self) -> ModuleCosts:
        return ModuleCosts(
            flops=self.flops,
            memory_bytes=self.memory,
            collective_bytes=sum(self.coll.values()),
            collective_by_kind=dict(self.coll),
            collective_counts=dict(self.coll_n),
            while_trip_counts={},
        )


def count_costs(fn: Callable, *args, **kwargs) -> tuple[Any, ModuleCosts]:
    """``(fn(*args, **kwargs), its ModuleCosts)``."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.costs()
