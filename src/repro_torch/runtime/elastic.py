"""Elastic re-meshing after node loss (counterpart of
src/repro/runtime/elastic.py).

Policy: the TP ('model') extent is an architectural invariant (weight shards
are laid out for it), so on losing hosts we shrink the *data-parallel* axis
to the largest extent the surviving chips support, keep the global batch by
raising per-shard microbatching, and reshard params from the last checkpoint
(checkpoint/manager.py ``restore`` with the new mesh's shardings).
"""
from __future__ import annotations

import dataclasses

__all__ = ["RemeshPlan", "plan_remesh"]


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    chips_used: int
    chips_idle: int
    microbatch_scale: int  # multiply num_microbatches by this to keep GBS

    @property
    def data_extent(self) -> int:
        return self.mesh_shape[self.mesh_axes.index("data")]


def plan_remesh(
    healthy_chips: int,
    model_extent: int,
    *,
    old_data_extent: int,
    pods: int = 1,
) -> RemeshPlan:
    """Largest (pod, data, model) mesh fitting on the surviving chips."""
    if healthy_chips < model_extent:
        raise ValueError(
            f"cannot keep TP={model_extent} with only {healthy_chips} chips"
        )
    per_pod = healthy_chips // max(pods, 1)
    data = per_pod // model_extent
    # data extent must divide the old extent so every new shard's data
    # stream is a union of old streams (deterministic replay, data/pipeline).
    while data > 1 and old_data_extent % data:
        data -= 1
    data = max(data, 1)
    used = pods * data * model_extent
    shape = (pods, data, model_extent) if pods > 1 else (data, model_extent)
    axes = ("pod", "data", "model") if pods > 1 else ("data", "model")
    return RemeshPlan(
        mesh_shape=shape,
        mesh_axes=axes,
        chips_used=used,
        chips_idle=healthy_chips - used,
        microbatch_scale=max(1, old_data_extent // data),
    )
