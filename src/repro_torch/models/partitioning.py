"""Logical-axis partitioning rules for every architecture (counterpart of
src/repro/models/partitioning.py).

Parameters and activations carry *logical* axis names; a rules table maps
them onto the physical mesh axes ("pod", "data", "model").  The rules
prefer divisible mappings (a 12-head axis stays replicated rather than
split unevenly 16 ways), and :meth:`AxisRules.sanitize` drops any mesh
axis that does not divide its dim.

Parallelism summary (DESIGN.md §5):
  DP   — batch over ("pod", "data")
  TP   — heads / ff / vocab / experts over "model"
  EP   — expert axis over "model"
  FSDP — the non-TP weight axis over "data" for archs with fsdp=True
  SP   — sequence over "model" at layer boundaries (activation constraint)

A spec is a :class:`PartitionSpec`, a tuple of per-dim parts (a mesh axis
name, a tuple of them, or None) whose ``tuple()`` is the reference's
``jax.sharding.PartitionSpec`` for the same spec.  On a
:class:`~torch.distributed.device_mesh.DeviceMesh` a spec becomes DTensor
placements (:func:`spec_to_placements`): one per mesh dim, ``Shard(i)``
where the mesh axis names dim ``i`` and ``Replicate()`` elsewhere, so a
tuple part splits its dim over its axes in mesh order, as GSPMD does.
Rules are computed from a mesh's axis names and sizes alone, so a
:class:`~repro_torch.launch.mesh.MeshShape` (no processes) gives the
rules of a 256-chip mesh, as the reference's ``AbstractMesh`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

from repro_torch.placement import Sharding, is_dtensor, spec_to_placements

__all__ = [
    "PartitionSpec",
    "AxisRules",
    "logical_to_pspec",
    "make_rules",
    "spec_to_placements",
    "Sharding",
    "spec_tree_to_shardings",
    "distribute_tree",
    "constrain",
    "relayout",
    "on_local_shards",
    "replicated_ops",
    "is_dtensor",
]

# Logical axis names used by the param schema / activation constraints.
#   batch     activation batch dim
#   seq       activation sequence dim (SP at layer boundaries)
#   embed     d_model axis of weights (FSDP axis when enabled)
#   q_heads   flattened n_heads*head_dim weight axis (TP)
#   kv_heads  flattened n_kv_heads*head_dim weight axis (TP if divisible)
#   heads_act per-head activation axis
#   ff        feed-forward hidden axis (TP)
#   vocab     vocabulary axis (TP)
#   expert    MoE expert axis (EP)
#   layers    stacked-layer leading axis (never sharded)
#   ssm_inner mamba d_inner axis (TP)
#   none      explicitly replicated


class PartitionSpec(tuple):
    """Per-dim mesh axes: ``PartitionSpec("data", None, ("pod", "data"))``.
    A tuple, so ``tuple(spec)`` compares with the reference's ``P``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _mesh_axes(mesh) -> tuple[tuple[str, ...], dict[str, int]]:
    """(axis names, {name: size}) of a DeviceMesh or a MeshShape."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, (int(n) for n in mesh.shape)))
    return names, sizes


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping from logical axis names to physical mesh axes.  ``mesh`` is
    the concrete DeviceMesh that :func:`constrain` places onto (None for
    rules computed from a MeshShape)."""

    rules: Mapping[str, Any]
    mesh_axes: tuple[str, ...]
    axis_sizes: Mapping[str, int] = dataclasses.field(default_factory=dict)
    mesh: Any = None

    def resolve(self, logical: Sequence[str | None]) -> PartitionSpec:
        out = [None if name is None or name == "none"
               else self.rules.get(name) for name in logical]
        # Trim trailing Nones for a canonical spec.
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    def _extent(self, part: Any) -> int:
        names = part if isinstance(part, tuple) else (part,)
        n = 1
        for name in names:
            n *= self.axis_sizes.get(name, 1)
        return n

    def sanitize(self, spec: Sequence, shape: Sequence[int]) -> PartitionSpec:
        """Drop sharded axes that do not divide the dim evenly (a dropped
        axis means 'replicate that dim'), and repeated uses of one mesh
        axis (a spec may name each axis at most once)."""
        parts = list(spec) + [None] * (len(shape) - len(spec))
        used: set = set()
        for i, part in enumerate(parts):
            if part is None:
                continue
            names = list(part) if isinstance(part, tuple) else [part]
            # Degrade tuple axes gracefully: ('pod', 'data') on a dim of 16
            # keeps ('data',) rather than dropping the sharding entirely.
            while names and (
                shape[i] % self._extent(tuple(names))
                or any(n in used for n in names)
            ):
                names.pop(0)
            if not names:
                parts[i] = None
            else:
                parts[i] = tuple(names) if len(names) > 1 else names[0]
                used.update(names)
        while parts and parts[-1] is None:
            parts.pop()
        return P(*parts)

    def spec_for(self, shape: Sequence[int],
                 logical: Sequence[str | None]) -> PartitionSpec:
        return self.sanitize(self.resolve(logical), shape)


def make_rules(
    mesh,
    *,
    fsdp: bool = False,
    n_heads: int = 0,
    n_kv_heads: int = 0,
) -> AxisRules:
    """The rules table for one (mesh, architecture) pair; ``mesh`` is a
    DeviceMesh or a MeshShape.

    ``batch`` spans every data-parallel axis present ("pod" and "data").
    Head *activation* axes shard only when the head count divides the
    model axis; the flattened weight axes always shard.
    """
    axes, sizes = _mesh_axes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in axes)
    batch = data_axes if len(data_axes) > 1 else (
        data_axes[0] if data_axes else None
    )
    model = "model" if "model" in axes else None
    model_size = sizes["model"] if model else 1
    heads_act = model if n_heads and n_heads % max(model_size, 1) == 0 else None
    kv_heads_act = (
        model if n_kv_heads and n_kv_heads % max(model_size, 1) == 0 else None
    )
    rules = {
        "batch": batch,
        "seq": model,           # sequence parallelism at layer boundaries
        "embed": "data" if (fsdp and "data" in axes) else None,
        "q_heads": model,
        "kv_heads": model,
        "heads_act": heads_act,
        "kv_heads_act": kv_heads_act,
        "ff": model,
        "vocab": model,
        "expert": model,
        "ssm_inner": model,
        "layers": None,
    }
    is_mesh = _is_device_mesh(mesh)
    return AxisRules(rules=rules, mesh_axes=axes, axis_sizes=sizes,
                     mesh=mesh if is_mesh else None)


def _is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def logical_to_pspec(rules: AxisRules,
                     logical: Sequence[str | None]) -> PartitionSpec:
    return rules.resolve(logical)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def spec_tree_to_shardings(mesh, spec_tree: Any) -> Any:
    """PartitionSpec tree -> the same tree of :class:`Sharding`s, each the
    spec's placements on ``mesh``."""
    if _is_spec(spec_tree):
        return Sharding(mesh, spec_to_placements(mesh, spec_tree))
    return {k: spec_tree_to_shardings(mesh, v) for k, v in spec_tree.items()}


def distribute_tree(mesh, tree: Any, specs: Any) -> Any:
    """Each tensor leaf of ``tree`` as a DTensor on ``mesh`` laid out by
    the matching leaf of ``specs``.  Every rank must pass the same full
    tensors; each keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor

    if torch.is_tensor(tree):
        # src_data_rank=None: each rank cuts its shard from its own copy,
        # with no collective.
        return distribute_tensor(tree.detach(), mesh,
                                 spec_to_placements(mesh, specs),
                                 src_data_rank=None)
    return {k: distribute_tree(mesh, v, specs[k]) for k, v in tree.items()}


def replicated_ops(active: bool = True):
    """A context in which plain tensors meeting DTensors count as
    replicated (DTensor's ``implicit_replication``): the model's
    constants (positions, masks, the routing's index tensors) mix with
    sharded activations.  A null context when ``active`` is false."""
    import contextlib

    if not active:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def on_local_shards(fn, outs, *args):
    """``fn(*args)`` on this rank's shards: every DTensor argument is
    replaced by its local tensor, and each output of ``fn`` becomes a
    DTensor on their mesh with the placements of the matching entry of
    ``outs`` (one placements tuple per output; a tensor output takes
    ``outs[0]``).  Plain arguments pass as they are; with no DTensor
    argument ``fn(*args)`` is returned as it is.

    For work that keeps each shard to itself (per channel, per row): each
    output shard depends only on the arguments' shards on the same rank.
    Differentiable: an argument replicated on a mesh dim over which an
    output is sharded gets a partial-sum gradient there (each rank saw
    its part of the outputs), a sharded one its own shard's gradient."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = dts[0].device_mesh
    split = [any(isinstance(o[i], Shard) for o in outs)
             for i in range(mesh.ndim)]

    def local(a):
        if not is_dtensor(a):
            return a
        if any(isinstance(p, Partial) for p in a.placements):
            raise ValueError("on_local_shards takes no partial sums: "
                             "reduce them first")
        grads = [Partial() if isinstance(p, Replicate) and split[i] else p
                 for i, p in enumerate(a.placements)]
        return a.to_local(grad_placements=grads)

    res = fn(*(local(a) for a in args))
    single = torch.is_tensor(res)
    res = [DTensor.from_local(r, mesh, o, run_check=False)
           for r, o in zip((res,) if single else res, outs)]
    return res[0] if single else tuple(res)


def relayout(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` redistributed to ``like``'s placements when both are
    DTensors that differ (a reduction of a partial, a gather or a
    reshard); ``t`` itself otherwise."""
    if is_dtensor(t) and is_dtensor(like) and \
            tuple(t.placements) != tuple(like.placements):
        return t.redistribute(like.device_mesh, like.placements)
    return t


def constrain(x: torch.Tensor, rules: AxisRules | None,
              *logical: str | None) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical names: a
    DTensor is redistributed to the spec sanitized against its shape.  A
    layout hint only: values never change.  A plain tensor, or rules with
    no mesh, pass through untouched."""
    if rules is None or rules.mesh is None or not is_dtensor(x):
        return x
    spec = rules.sanitize(rules.resolve(logical), x.shape)
    return x.redistribute(x.device_mesh,
                          spec_to_placements(x.device_mesh, spec))
