"""The training step and the step's input specs (counterpart of
src/repro/train/step.py:41-229).

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

On a mesh (``rules`` with a DeviceMesh) the parameters and moments are
DTensors (launch/train.py ``build_trainer``).  The global batch comes in
as plain tensors, the same on every rank; each microbatch is cut from it
first and enters sharded over the batch axes, so every mesh trains on the
same global batch.  The forward runs over DTensors with the model's
sharding constraints, the gradients are pinned to ``grad_pspecs`` (the
parameters' own layout by default; the reference's pin of its float32
accumulator, step.py:88-99), and AdamW updates in the moments' ZeRO-1
layout.  The loss and the metrics come back as plain tensors.

``make_prefill_step`` and ``make_decode_step`` are the reference's serve
steps (step.py:137-170) over models/model.py's ``prefill_step`` and
``decode_step``, under ``rules``; the dry run (launch/dryrun.py) is their
caller.  The reference's
int8 cross-pod hop is described in its optim/compression.py but no step
of the JAX package runs it, so none runs here.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.models.model import decode_step as _decode_step
from repro_torch.models.model import loss_fn
from repro_torch.models.model import prefill_step as _prefill_step
from repro_torch.models.params import decay_mask
from repro_torch.models.partitioning import (
    AxisRules,
    PartitionSpec as P,
    is_dtensor,
    relayout,
    replicated_ops,
    spec_to_placements,
)
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.schedule import linear_warmup_cosine

__all__ = ["TrainHParams", "accumulate_grads", "make_train_step",
           "make_prefill_step", "make_decode_step", "shard_batch",
           "train_input_specs", "serve_input_specs"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

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


def shard_batch(batch: dict, rules: AxisRules | None) -> dict:
    """The plain global ``batch`` (the same on every rank) as DTensors
    sharded over the rules' batch axes, each rank cutting its rows from
    its own copy; unchanged without a mesh."""
    if rules is None or rules.mesh is None:
        return batch
    from torch.distributed.tensor import distribute_tensor

    mesh = rules.mesh
    spec = rules.sanitize(P(rules.rules.get("batch")),
                          (batch["tokens"].shape[0],))
    return {k: distribute_tensor(v, mesh, spec_to_placements(mesh, spec),
                                 src_data_rank=None)
            for k, v in batch.items()}


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if is_dtensor(t) else t


def accumulate_grads(
    cfg: ModelConfig, hp: TrainHParams, params: dict, batch: dict, *,
    rules: AxisRules | None = None, grad_pspecs: dict | None = None,
) -> tuple[torch.Tensor, dict, dict]:
    """``(loss, parts, grads)`` of ``batch`` over ``hp.num_microbatches``:
    the mean loss, ``loss_fn``'s ``{"xent", "aux", "dropped_frac"}`` with
    one microbatch (``{}`` with more, as the reference), and the mean
    gradient tree, float32 with more than one microbatch (in the
    parameters' dtype with one, as the reference).  Every parameter leaf
    is made to require grad.  With ``rules`` on a mesh each microbatch
    enters sharded (:func:`shard_batch`) and every gradient is laid out
    by ``grad_pspecs`` (default: its parameter's layout)."""
    leaves, spec = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    mesh = rules.mesh if rules is not None else None
    if mesh is not None and grad_pspecs is not None:
        from torch.distributed.tensor import zeros as dzeros

        pins = [dzeros(tuple(p.shape), dtype=torch.float32, device_mesh=mesh,
                       placements=spec_to_placements(mesh, s))
                for p, s in zip(leaves, tree_flatten(grad_pspecs)[0])]
    else:
        pins = None

    def grads_of(mb):
        mb = shard_batch(mb, rules)
        extras = {k: mb[k] for k in EXTRAS if k in mb}
        with torch.enable_grad(), replicated_ops(mesh is not None):
            loss, parts = loss_fn(cfg, params, mb["tokens"], mb["labels"],
                                  aux_weight=hp.aux_weight, rules=rules,
                                  **extras)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None
              else relayout(g, p if pins is None else pins[i])
              for i, (g, p) in enumerate(zip(gs, leaves))]
        return (_plain(loss.detach()),
                {k: _plain(v.detach()) for k, v in parts.items()}, gs)

    if hp.num_microbatches <= 1:
        loss, parts, gs = grads_of(batch)
        return loss, parts, tree_unflatten(gs, spec)
    acc = pins or [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    l_sum = None
    for mb in _split_batch(batch, hp.num_microbatches):
        loss, _, gs = grads_of(mb)
        with replicated_ops(mesh is not None):
            for a, g in zip(acc, gs):
                a.add_(relayout(g.float(), a))
        l_sum = loss if l_sum is None else l_sum + loss
    inv = 1.0 / hp.num_microbatches
    with replicated_ops(mesh is not None):
        grads = [a * inv for a in acc]
    return l_sum * inv, {}, tree_unflatten(grads, spec)


def make_train_step(cfg: ModelConfig, hp: TrainHParams, *,
                    rules: AxisRules | None = None,
                    grad_pspecs: dict | None = None,
                    decay: dict | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds ``tokens``/``labels`` (b, s) and the
    modality extras, plain tensors.  ``metrics``: ``loss`` and ``lr``,
    plus ``xent``, ``aux`` and ``dropped_frac`` with one microbatch, plain
    device scalars.  ``decay`` is AdamW's decay mask (default
    ``models.params.decay_mask(cfg)``, ROADMAP C14; pass
    ``optim.adamw.decay_by_rank(params)`` for the reference's rule).
    ``rules`` (an ``AxisRules`` on a DeviceMesh) and ``grad_pspecs`` (a
    PartitionSpec tree beside the parameters) run the sharded step
    (module docstring)."""
    decay = decay_mask(cfg) if decay is None else decay

    def train_step(params, opt_state, batch):
        loss, parts, grads = accumulate_grads(
            cfg, hp, params, batch, rules=rules, grad_pspecs=grad_pspecs)
        lr = linear_warmup_cosine(
            opt_state["step"], hp.base_lr, hp.warmup_steps, hp.total_steps)
        params, opt_state = adamw_update(
            hp.adamw, params, grads, opt_state, lr, decay)
        return params, opt_state, {"loss": loss, "lr": lr, **parts}

    return train_step


def make_prefill_step(cfg: ModelConfig, rules: AxisRules | None,
                      cache_len: int):
    """``prefill_step(params, batch) -> (last_logits (b, vocab), cache)``:
    ``batch`` holds ``tokens`` (b, s) with no pad, and the modality extras.
    The logits are those of row s - 1 (the reference's ``logits[:, -1]``);
    the MoE statistics are dropped."""

    def prefill_step(params, batch):
        extras = {k: batch[k] for k in EXTRAS if k in batch}
        tokens = batch["tokens"]
        logits, cache, _ = _prefill_step(
            cfg, params, tokens, cache_len=cache_len,
            last=tokens.shape[1] - 1, rules=rules, **extras)
        return logits, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, rules: AxisRules | None,
                     cache_len: int):
    """``decode_step(params, cache, tokens (b, 1), pos) -> (logits (b,
    vocab), cache)`` with ``pos`` one position for the whole batch (the
    reference's scalar ``pos``; a (b,) ``pos`` on a sequence-sharded cache
    raises ``PerRowPosError``).  The cache is ``cache_len`` long and is
    updated in place; the MoE statistics are dropped."""

    def decode_step(params, cache, tokens, pos):
        logits, cache, _ = _decode_step(cfg, params, cache, tokens, pos,
                                        rules=rules)
        return logits, cache

    return decode_step


# ---------------------------------------------------------------------------
# Input specs (meta-tensor stand-ins) and their PartitionSpecs
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _extras(cfg: ModelConfig, b: int, bspec, specs: dict, pspecs: dict):
    dt = _DTYPES[cfg.dtype]
    if cfg.vision_prefix:
        specs["vision_embeds"] = _meta((b, cfg.vision_prefix, cfg.d_model),
                                       dt)
        pspecs["vision_embeds"] = bspec
    if cfg.encoder_decoder:
        specs["encoder_frames"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                                        dt)
        pspecs["encoder_frames"] = bspec


def train_input_specs(
    cfg: ModelConfig, shape: ShapeSpec, rules: AxisRules
) -> tuple[dict, dict]:
    """(meta-tensor batch, PartitionSpec batch) for a training cell
    (src/repro/train/step.py:177-200)."""
    b, s = shape.global_batch, shape.seq_len
    bspec = rules.sanitize(P(rules.rules.get("batch")), (b,))
    specs = {"tokens": _meta((b, s), torch.int32),
             "labels": _meta((b, s), torch.int32)}
    pspecs = {"tokens": bspec, "labels": bspec}
    _extras(cfg, b, bspec, specs, pspecs)
    return specs, pspecs


def serve_input_specs(
    cfg: ModelConfig, shape: ShapeSpec, rules: AxisRules
) -> tuple[dict, dict]:
    """Inputs of a prefill (the whole request) or a decode (one token and
    its position) cell (src/repro/train/step.py:203-229)."""
    b, s = shape.global_batch, shape.seq_len
    bspec = rules.sanitize(P(rules.rules.get("batch")), (b,))
    if shape.kind == "prefill":
        specs = {"tokens": _meta((b, s), torch.int32)}
        pspecs = {"tokens": bspec}
        _extras(cfg, b, bspec, specs, pspecs)
        return specs, pspecs
    specs = {"tokens": _meta((b, 1), torch.int32),
             "pos": _meta((), torch.int32)}
    return specs, {"tokens": bspec, "pos": P()}
