"""The training step (counterpart of src/repro/train/step.py:41-134).

``make_train_step`` builds ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the batch split into microbatches, the
remat'd train-mode forward (``models.model.loss_fn``) differentiated by
autograd, the gradients accumulated in float32, then AdamW at the
warmup + cosine learning rate of the step before the increment.  It runs
plain torch on any device, as the reference's step runs inline XLA: no
Pallas kernel lies on the reference's train path, so no hand-written
kernel lies on this one.

The gradients come from ``torch.autograd.grad`` into float32 buffers,
not from ``.grad``: PyTorch accumulates ``.grad`` in the parameter's
dtype (bf16), the reference accumulates in float32 (step.py:99-109).
The parameters and moments are updated in place.

The prefill and decode steps live in models/model.py; the sharded
step's gradient pins and the int8 cross-pod hop wait for the mesh.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.models.params import decay_mask
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.schedule import linear_warmup_cosine

__all__ = ["TrainHParams", "accumulate_grads", "make_train_step"]

EXTRAS = ("vision_embeds", "encoder_frames")


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    num_microbatches: int = 1
    adamw: AdamWConfig = AdamWConfig()
    aux_weight: float = 0.01


def _split_batch(batch: dict, num_mb: int) -> list[dict]:
    """(B, ...) leaves -> ``num_mb`` microbatches of B / num_mb rows, in
    row order (the reference's reshape to (num_mb, B / num_mb, ...))."""
    b = batch["tokens"].shape[0]
    if b % num_mb:
        raise ValueError(f"batch {b} does not split into {num_mb} "
                         "microbatches")
    n = b // num_mb
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(num_mb)]


def accumulate_grads(
    cfg: ModelConfig, hp: TrainHParams, params: dict, batch: dict
) -> tuple[torch.Tensor, dict, dict]:
    """``(loss, parts, grads)`` of ``batch`` over ``hp.num_microbatches``:
    the mean loss, ``loss_fn``'s ``{"xent", "aux", "dropped_frac"}`` with
    one microbatch (``{}`` with more, as the reference), and the mean
    gradient tree, float32 with more than one microbatch (in the
    parameters' dtype with one, as the reference).  Every parameter leaf
    is made to require grad."""
    leaves, spec = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)

    def grads_of(mb):
        extras = {k: mb[k] for k in EXTRAS if k in mb}
        with torch.enable_grad():
            loss, parts = loss_fn(cfg, params, mb["tokens"], mb["labels"],
                                  aux_weight=hp.aux_weight, **extras)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for g, p in zip(gs, leaves)]
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, gs

    if hp.num_microbatches <= 1:
        loss, parts, gs = grads_of(batch)
        return loss, parts, tree_unflatten(gs, spec)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    l_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for mb in _split_batch(batch, hp.num_microbatches):
        loss, _, gs = grads_of(mb)
        for a, g in zip(acc, gs):
            a.add_(g.float())
        l_sum = l_sum + loss
    inv = 1.0 / hp.num_microbatches
    return l_sum * inv, {}, tree_unflatten([a * inv for a in acc], spec)


def make_train_step(cfg: ModelConfig, hp: TrainHParams, *,
                    decay: dict | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds ``tokens``/``labels`` (b, s) and the
    modality extras.  ``metrics``: ``loss`` and ``lr``, plus ``xent``,
    ``aux`` and ``dropped_frac`` with one microbatch, device scalars.
    ``decay`` is AdamW's decay mask (default
    ``models.params.decay_mask(cfg)``, ROADMAP C14; pass
    ``optim.adamw.decay_by_rank(params)`` for the reference's rule)."""
    decay = decay_mask(cfg) if decay is None else decay

    def train_step(params, opt_state, batch):
        loss, parts, grads = accumulate_grads(cfg, hp, params, batch)
        lr = linear_warmup_cosine(
            opt_state["step"], hp.base_lr, hp.warmup_steps, hp.total_steps)
        params, opt_state = adamw_update(
            hp.adamw, params, grads, opt_state, lr, decay)
        return params, opt_state, {"loss": loss, "lr": lr, **parts}

    return train_step
