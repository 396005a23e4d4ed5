"""Where a tensor lives on a mesh: a spec's DTensor placements, and the
(mesh, placements) pair of one leaf.

Dependency-free within the package, so that a lower layer
(``checkpoint/``) and ``models/partitioning.py`` share it without the
checkpoint layer depending on the model package.  A spec is a sequence of
per-dim parts (a mesh axis name, a tuple of them, or None), as
``models.partitioning.PartitionSpec`` builds it.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

__all__ = ["Sharding", "is_dtensor", "spec_to_placements"]


class Sharding(NamedTuple):
    """Where a leaf lives: its mesh and its DTensor placements (the
    reference's ``NamedSharding``)."""

    mesh: Any
    placements: tuple


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def spec_to_placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(i)`` when the dim's axis names tensor dim ``i`` (alone or in a
    tuple part), ``Replicate()`` otherwise.  A tuple part's axes must come
    in mesh order (the rules only build ``("pod", "data")``).  An axis of
    extent 1 shards nothing, so it places ``Replicate()``: the same
    layout, and one DTensor's view ops take on every torch version (some
    refuse to flatten two dims sharded even over extent-1 axes)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(int(n) for n in mesh.shape)
    out = [Replicate()] * len(names)
    for i, part in enumerate(spec):
        if part is None:
            continue
        group = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec part {part} is not in mesh order {names}")
        for j in idx:
            if sizes[j] > 1:
                out[j] = Shard(i)
    return tuple(out)
