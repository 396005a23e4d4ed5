"""Analytic per-device memory accounting from (tensor, PartitionSpec)
trees: the dry run's "fits in HBM" proof (counterpart of
src/repro/roofline/memory.py).

Leaves are tensors of any device, ``meta`` included (only shape and dtype
are read; a DTensor counts by its global shape); specs are the port's
``models.partitioning.PartitionSpec``.  An uneven dim counts its padded
shard, ``ceil(dim / extent)``, as GSPMD pads it.  The trees are walked in
sorted key order, the reference's leaf order, so the sum is the
reference's to the last bit.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import torch

from repro_torch.models.partitioning import PartitionSpec

__all__ = ["tree_device_bytes", "fits_hbm"]


def _leaf_device_bytes(
    leaf: torch.Tensor, spec: PartitionSpec, axis_sizes: Mapping[str, int]
) -> float:
    shape = tuple(leaf.shape)
    total = float(math.prod(shape) or 1) * leaf.dtype.itemsize
    div = 1
    for i, part in enumerate(tuple(spec)):
        if part is None:
            continue
        names = part if isinstance(part, tuple) else (part,)
        extent = 1
        for n in names:
            extent *= axis_sizes.get(n, 1)
        # GSPMD pads uneven dims; account for the padded shard.
        dim = shape[i]
        shard = math.ceil(dim / extent)
        div *= dim / max(shard, 1) if shard else 1
    return total / max(div, 1)


def _pairs(tree: Any, specs: Any) -> list[tuple[torch.Tensor, PartitionSpec]]:
    if isinstance(specs, PartitionSpec):
        return [(tree, specs)]
    if isinstance(tree, dict):
        if sorted(tree) != sorted(specs):
            raise ValueError(f"tree keys {sorted(tree)} != spec keys "
                             f"{sorted(specs)}")
        return [p for k in sorted(tree) for p in _pairs(tree[k], specs[k])]
    raise TypeError(f"no PartitionSpec beside a {type(tree).__name__} leaf")


def tree_device_bytes(
    tree: Any, spec_tree: Any, axis_sizes: Mapping[str, int]
) -> float:
    """Bytes one device holds of ``tree`` laid out by ``spec_tree`` on a
    mesh of ``axis_sizes`` ({"data": 16, "model": 16}, say)."""
    return sum(_leaf_device_bytes(t, s, axis_sizes)
               for t, s in _pairs(tree, spec_tree))


def fits_hbm(per_device_bytes: float, hbm_bytes: float,
             headroom: float = 0.9) -> bool:
    return per_device_bytes <= hbm_bytes * headroom
