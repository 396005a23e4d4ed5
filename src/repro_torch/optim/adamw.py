"""AdamW on nested dicts of tensors (counterpart of
src/repro/optim/adamw.py:37-101).

The moments are float32 whatever the parameters' dtype, the gradients are
clipped to a global norm, and each leaf's update is computed in float32
and cast to the parameter's dtype once, as the reference does
(adamw.py:84-91).  ``torch.optim.AdamW`` rounds bf16 parameters at every
op of its update, so it is not used.

Which leaves decay is a mask the caller passes.  The reference decays
every leaf of rank >= 2 (:func:`decay_by_rank`, the default here), and
its stacked layers' norm gains are rank 2 there (ROADMAP C14); the
trainer passes ``models.params.decay_mask(cfg)``, which decides from each
leaf's rank before stacking.

On a mesh the parameters, gradients and moments are DTensors.
:func:`opt_state_pspecs` lays the moments out ZeRO-1 style (src/repro/
optim/adamw.py:105-135): each moment takes its parameter's spec plus the
"data" axis on its first free divisible dim, and :func:`adamw_init`
allocates them so, sharded for real.  :func:`adamw_update` computes each
leaf's update in the moment's layout and writes it back in the
parameter's.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.models.partitioning import (
    PartitionSpec,
    is_dtensor,
    relayout,
    replicated_ops,
    spec_to_placements,
)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "decay_by_rank",
    "global_norm", "opt_state_pspecs",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _shard_spec_for_moment(spec: PartitionSpec, shape: tuple[int, ...],
                           data_divisor: int) -> PartitionSpec:
    """ZeRO-1: add 'data' to the first unsharded axis divisible by the data
    axis; keep the param's own spec otherwise."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if any(p == "data" or (isinstance(p, tuple) and "data" in p)
           for p in parts):
        return spec  # FSDP params: moments inherit
    for i, (p, dim) in enumerate(zip(parts, shape)):
        if p is None and dim % data_divisor == 0 and dim >= data_divisor:
            parts[i] = "data"
            while parts and parts[-1] is None:
                parts.pop()
            return PartitionSpec(*parts)
    return spec


def _map_specs(fn, specs, *trees):
    if isinstance(specs, PartitionSpec):
        return fn(specs, *trees)
    return {k: _map_specs(fn, v, *(t[k] for t in trees))
            for k, v in specs.items()}


def opt_state_pspecs(param_specs: dict, param_shapes: dict,
                     data_axis_size: int, zero1: bool = True) -> dict:
    """PartitionSpec tree for the optimizer state; ``param_shapes`` is any
    tree of leaves with a ``.shape`` beside ``param_specs``."""
    if zero1 and data_axis_size > 1:
        moment = _map_specs(
            lambda s, p: _shard_spec_for_moment(s, tuple(p.shape),
                                                data_axis_size),
            param_specs, param_shapes)
    else:
        moment = param_specs
    return {"mu": moment, "nu": moment, "step": PartitionSpec()}


def adamw_init(params: dict, *, mesh=None, specs: dict | None = None
               ) -> dict:
    """Zeroed float32 moments beside ``params`` and a step count of 0 (an
    int32 scalar on the parameters' device).  With ``mesh`` and ``specs``
    (:func:`opt_state_pspecs`'s tree) each moment is a DTensor laid out by
    its spec: every rank allocates its shard only."""
    if mesh is not None:
        from torch.distributed.tensor import zeros as dzeros

        def moments(tree, spec_tree):
            return _map_specs(
                lambda sp, p: dzeros(
                    tuple(p.shape), dtype=torch.float32, device_mesh=mesh,
                    placements=spec_to_placements(mesh, sp)),
                spec_tree, tree)

        mu, nu = moments(params, specs["mu"]), moments(params, specs["nu"])
    else:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        mu, nu = tree_map(zeros, params), tree_map(zeros, params)
    return {
        "mu": mu,
        "nu": nu,
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
    }


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def decay_by_rank(params: dict) -> dict:
    """The reference's rule: decay every leaf of rank >= 2."""
    return tree_map(lambda p: p.ndim >= 2, params)


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params: dict,
    grads: dict,
    opt_state: dict,
    lr: torch.Tensor | float,
    decay: dict | None = None,
) -> tuple[dict, dict]:
    """One AdamW step with global-norm clipping, IN PLACE: every parameter
    and moment tensor is overwritten and the same trees come back as
    ``(params, opt_state)`` (the step count is a new tensor).  ``decay``
    is a tree of bools beside ``params`` (default
    :func:`decay_by_rank`)."""
    if decay is None:
        decay = decay_by_rank(params)
    with replicated_ops(is_dtensor(tree_leaves(params)[0])):
        return _update(cfg, params, grads, opt_state, lr, decay)


def _update(cfg, params, grads, opt_state, lr, decay):
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    def upd(p, g, mu, nu, dec):
        # Over DTensors the update runs in the moment's (ZeRO-1) layout
        # and is written back in the parameter's.
        g = relayout(g.float(), mu) * scale
        mu.copy_(cfg.b1 * mu + (1.0 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1.0 - cfg.b2) * g * g)
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        pf = relayout(p.float(), mu)
        if dec:
            delta = delta + cfg.weight_decay * pf
        p.copy_(relayout((pf - lr * delta).to(p.dtype), p))

    tree_map(upd, params, grads, opt_state["mu"], opt_state["nu"], decay)
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                    "step": step}
