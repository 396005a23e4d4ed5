"""The attention decoder, dense or MoE (counterpart of
src/repro/models/model.py).

A model is ``n_groups`` repetitions of a layer ``pattern``; parameters and
caches are stacked per pattern position over groups, as in the reference,
and the forward pass is a Python loop over groups (the reference's
``lax.scan``; PyTorch runs eagerly).

Entry points:
  * :func:`make_cache`  — a zeroed decode cache (:func:`abstract_cache`:
    its shapes and dtypes as meta tensors),
  * :func:`forward`     — logits for prefill/decode,
  * :func:`prefill_step` / :func:`decode_step` — the serving steps (the
    reference's train/step.py:137-165 folded in).  ``prefill_step`` takes
    the logits of the row the caller names — the last REAL prompt token —
    where the reference reads the last padded position.

Decode takes ``pos`` as an int (every batch row at one position) or a
``(b,)`` integer tensor (each row at its own position: one step serves
rows at mixed progress, as the continuous-batching scheduler needs).  An
int becomes a ``(b,)`` tensor up front, so the layers have one decode path.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    attn_forward,
    mlp_forward,
    moe_forward,
    norm,
)

__all__ = [
    "make_cache", "abstract_cache", "forward", "prefill_step", "decode_step",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_cache(
    cfg: ModelConfig, batch: int, cache_len: int, device="cuda"
) -> dict:
    """Zeroed decode cache; leaves (G, b, kv_heads, cache_len, head_dim)."""
    shape = (
        cfg.n_groups, batch, cfg.n_kv_heads, cache_len, cfg.resolved_head_dim
    )
    dt = _DTYPES[cfg.dtype]
    return {
        f"pos{p}": {
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
        }
        for p in range(len(cfg.pattern))
    }


def abstract_cache(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """:func:`make_cache`'s tree as meta tensors: the leaves' shapes and
    dtypes, with no storage (the reference's ``abstract_cache``)."""
    return make_cache(cfg, batch, cache_len, device="meta")


def _hidden(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    *,
    mode: str,
    cache: dict | None,
    pos: int | torch.Tensor | None,
    cache_len: int,
    out_cache: dict | None = None,
) -> tuple[torch.Tensor, dict, dict]:
    """Embedding through the final norm: (hidden (b, s, d), cache,
    moe_stats).  ``moe_stats`` holds the mean ``dropped_frac`` over the
    MoE layers (a device scalar; 0 without MoE layers) and ``topi``, each
    MoE layer's (b, s, k) expert choices in layer order.  A prefill with
    ``out_cache`` (a :func:`make_cache`-shaped tree) writes each layer's
    k/v into its first s rows in place and returns it; the rows past s
    keep what they held (every decode read is kv_len-masked)."""
    if not cfg.use_rope:
        raise NotImplementedError(
            f"{cfg.name}: absolute positions are not ported yet"
        )
    b, s = tokens.shape
    x = params["embed"][tokens]
    if cfg.embed_scale:
        # Gemma's sqrt(d) scale, in f32 then cast (model.py:269-270).
        x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
    dev = x.device
    # RoPE positions: (s,) in prefill, (b, 1) in decode.  Decode has one
    # path: an int ``pos`` is every row at that position.
    if mode != "decode":
        positions = torch.arange(s, device=dev)
    else:
        if not torch.is_tensor(pos):
            pos = torch.full((b,), pos, dtype=torch.int32, device=dev)
        positions = pos.reshape(b, 1)
    n_pos = len(cfg.pattern)
    new_layers: list[list[dict]] = [[] for _ in range(n_pos)]
    dropped: list[torch.Tensor] = []
    topis: list[torch.Tensor] = []
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.pattern):
            p = _slice(params[f"pos{i}"], g)
            c = _slice(cache[f"pos{i}"], g) if mode == "decode" else None
            h = norm(x, p["norm_mixer"], cfg)
            y, nc = attn_forward(
                p["attn"], h, cfg, spec, mode=mode, positions=positions,
                cache=c, pos=pos,
                cache_len=s if out_cache is not None else cache_len,
            )
            if out_cache is not None:
                for name in ("k", "v"):
                    out_cache[f"pos{i}"][name][g, :, :, :s].copy_(nc[name])
            else:
                new_layers[i].append(nc)
            x = x + y
            if spec.mlp == "dense":
                x = x + mlp_forward(p["mlp"], norm(x, p["norm_mlp"], cfg), cfg)
            elif spec.mlp == "moe":
                y, _, drop, topi = moe_forward(
                    p["moe"], norm(x, p["norm_mlp"], cfg), cfg
                )
                x = x + y
                dropped.append(drop)
                topis.append(topi)
    if mode == "decode":
        new_cache = cache  # written in place, layer by layer
    elif out_cache is not None:
        new_cache = out_cache
    else:
        new_cache = {
            f"pos{i}": {
                name: torch.stack([nc[name] for nc in new_layers[i]])
                for name in ("k", "v")
            }
            for i in range(n_pos)
        }
    stats = {
        "dropped_frac": (
            torch.stack(dropped).mean() if dropped
            else torch.zeros((), device=dev)
        ),
        "topi": topis,
    }
    return norm(x, params["final_norm"], cfg), new_cache, stats


def _slice(tree: dict, g: int) -> dict:
    """Group ``g`` of a stacked tree: views, so decode writes land in the
    stacked cache."""
    return {
        k: _slice(v, g) if isinstance(v, dict) else v[g]
        for k, v in tree.items()
    }


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.logit_softcap is not None:
        c = cfg.logit_softcap
        logits = (torch.tanh(logits.float() / c) * c).to(logits.dtype)
    if cfg.vocab_padded != cfg.vocab:
        # Mask the padding columns so argmax never sees them.
        logits[..., cfg.vocab:] = -1e30
    return logits


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    *,
    mode: str = "prefill",
    cache: dict | None = None,
    pos: int | torch.Tensor | None = None,
    cache_len: int = 0,
    return_moe_stats: bool = False,
) -> tuple:
    """Run the model: ``tokens`` (b, s) int — s == 1 in decode mode with
    ``pos`` the position of the new token, an int or a (b,) tensor of
    per-row positions.  Returns
    ``(logits (b, s, vocab_padded), cache[, moe_stats])``; in prefill the
    cache leaves are ``cache_len`` long, in decode ``cache`` is updated in
    place.  ``return_moe_stats`` appends ``{"dropped_frac": mean fraction
    of (token, choice) assignments the MoE capacity bound dropped, over
    the MoE layers, "topi": per-layer expert choices}``."""
    x, new_cache, stats = _hidden(
        cfg, params, tokens, mode=mode, cache=cache, pos=pos,
        cache_len=cache_len,
    )
    ret = (_head(cfg, params, x), new_cache)
    return ret + (stats,) if return_moe_stats else ret


def prefill_step(
    cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
    cache_len: int, last: int, out_cache: dict | None = None,
) -> tuple[torch.Tensor, dict, dict]:
    """Prefill a bucket-padded batch: ``(logits at row last (b, vocab),
    cache, moe_stats)`` (``moe_stats`` as :func:`forward` returns it).
    ``last`` is the index of the last real prompt token (s - 1), so the
    bucket's pad positions never pick the first token.  ``out_cache``
    (``cache_len`` long) receives the cache in place instead of fresh
    zero-padded leaves."""
    x, cache, stats = _hidden(
        cfg, params, tokens, mode="prefill", cache=None, pos=None,
        cache_len=cache_len, out_cache=out_cache,
    )
    return _head(cfg, params, x[:, last]), cache, stats


def decode_step(
    cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
    pos: int | torch.Tensor,
) -> tuple[torch.Tensor, dict, dict]:
    """One decode token: ``(logits (b, vocab), cache, moe_stats)``; ``pos``
    is one position for the batch or a (b,) tensor of per-row ones."""
    x, cache, stats = _hidden(
        cfg, params, tokens, mode="decode", cache=cache, pos=pos,
        cache_len=0,
    )
    return _head(cfg, params, x[:, 0]), cache, stats
