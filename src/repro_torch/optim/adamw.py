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
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_leaves, tree_map

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "decay_by_rank",
    "global_norm",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: dict) -> dict:
    """Zeroed float32 moments beside ``params`` and a step count of 0 (an
    int32 scalar on the parameters' device)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
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
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    def upd(p, g, mu, nu, dec):
        g = g.float() * scale
        mu.copy_(cfg.b1 * mu + (1.0 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1.0 - cfg.b2) * g * g)
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        if dec:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    tree_map(upd, params, grads, opt_state["mu"], opt_state["nu"], decay)
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                    "step": step}
