"""The model, dense, MoE, MLA, SSM, hybrid, encoder-decoder (whisper) or
with a vision prefix (internvl2) (counterpart of
src/repro/models/model.py).

A model is ``n_groups`` repetitions of a layer ``pattern``; parameters and
caches are stacked per pattern position over groups, as in the reference,
and the forward pass is a Python loop over groups (the reference's
``lax.scan``; PyTorch runs eagerly).

Entry points:
  * :func:`make_cache`  — a zeroed decode cache (:func:`abstract_cache`:
    its shapes and dtypes as meta tensors), one leaf set per mixer:
    attention ``k``/``v``, MLA ``ckv``/``k_rope``, Mamba ``conv``/``ssm``
    (:data:`CACHE_SEQ_AXIS` names the leaves that have a sequence axis),
    and, for an encoder-decoder, the bare ``encoder_out`` leaf,
  * :func:`forward`     — logits for prefill/decode,
  * :func:`prefill_step` / :func:`decode_step` — the serving steps (the
    reference's train/step.py:137-165 folded in).  ``prefill_step`` takes
    the logits of the row the caller names — the last REAL prompt token —
    where the reference reads the last padded position.

Decode takes ``pos`` as an int (every batch row at one position) or a
``(b,)`` integer tensor (each row at its own position: one step serves
rows at mixed progress, as the continuous-batching scheduler needs).  An
int becomes a ``(b,)`` tensor up front, so the layers have one decode path.

The frontends are stubs, as in the reference: an encoder-decoder's prefill
takes ``encoder_frames`` (b, encoder_seq, d), precomputed frame
embeddings, and a VLM's may take ``vision_embeds`` (b, vision_prefix, d),
which overwrite the first positions' embeddings; the server feeds zeros.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (
    attn_forward,
    mamba_forward,
    mla_forward,
    mlp_forward,
    moe_forward,
    norm,
    sinusoid,
)

__all__ = [
    "make_cache", "abstract_cache", "forward", "prefill_step", "decode_step",
    "CACHE_SEQ_AXIS",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# The cache-length axis of each leaf that has one (leaves carry the leading
# stacked-groups axis); Mamba's ``conv`` and ``ssm`` state has none.
CACHE_SEQ_AXIS = {"k": 3, "v": 3, "ckv": 2, "k_rope": 2}


def _cache_entry_defs(
    cfg: ModelConfig, spec: LayerSpec, batch: int, cache_len: int
) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """(shape, dtype) per cache leaf of one pattern position, without the
    groups axis (src/repro/models/model.py:48-72)."""
    dt = _DTYPES[cfg.dtype]
    if spec.mixer == "attn":
        shape = (batch, cfg.n_kv_heads, cache_len, cfg.resolved_head_dim)
        return {"k": (shape, dt), "v": (shape, dt)}
    if spec.mixer == "mla":
        m = cfg.mla
        return {
            "ckv": ((batch, cache_len, m.kv_lora_rank), dt),
            "k_rope": ((batch, cache_len, m.qk_rope_dim), dt),
        }
    if spec.mixer == "mamba":
        s = cfg.ssm
        return {
            "conv": ((batch, s.d_conv - 1, s.d_inner), dt),
            "ssm": ((batch, s.d_inner, s.d_state), torch.float32),
        }
    raise ValueError(f"unknown mixer {spec.mixer!r}")


def make_cache(
    cfg: ModelConfig, batch: int, cache_len: int, device="cuda"
) -> dict:
    """Zeroed decode cache: per pattern position, its mixer's leaves with
    a leading groups axis (:func:`_cache_entry_defs`); an encoder-decoder
    adds ``encoder_out`` (batch, encoder_seq, d_model), a bare tensor with
    no groups axis that the prefill writes whole and never grows
    (src/repro/models/model.py:91-96)."""
    G = cfg.n_groups
    cache = {
        f"pos{p}": {
            name: torch.zeros((G,) + shape, dtype=dt, device=device)
            for name, (shape, dt) in _cache_entry_defs(
                cfg, spec, batch, cache_len).items()
        }
        for p, spec in enumerate(cfg.pattern)
    }
    if cfg.encoder_decoder:
        cache["encoder_out"] = torch.zeros(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=_DTYPES[cfg.dtype],
            device=device)
    return cache


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
    last: torch.Tensor | None = None,
    vision_embeds: torch.Tensor | None = None,
    encoder_frames: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict, dict]:
    """Embedding through the final norm: (hidden (b, s, d), cache,
    moe_stats).  ``moe_stats`` holds the mean ``dropped_frac`` over the
    MoE layers (a device scalar; 0 without MoE layers) and ``topi``, each
    MoE layer's (b, s, k) expert choices in layer order.  A prefill with
    ``out_cache`` (a :func:`make_cache`-shaped tree) writes each layer's
    k/v (ckv/k_rope) into its first s rows in place, and its Mamba state
    whole, and its ``encoder_out`` whole, and returns it; the rows past s
    keep what they held (every decode read is masked past ``pos``).
    ``last`` ((1,) integer tensor) is the prefill's last real row, whose
    state the Mamba layers keep.  ``vision_embeds`` and ``encoder_frames``
    are the frontend stubs' inputs (module docstring)."""
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
    if not cfg.use_rope:
        # Sinusoidal absolute positions (src/repro/models/model.py:271-286):
        # over the padded bucket in prefill, each row's own in decode, from
        # the device ``pos`` (a decode graph refills it before each replay).
        x = x + sinusoid(positions, cfg.d_model).to(x.dtype)
    if vision_embeds is not None and mode != "decode":
        nv = vision_embeds.shape[1]
        if s < nv:
            # The reference's concatenation would yield nv rows here and
            # break the rope broadcast (ROADMAP C13).
            raise ValueError(
                f"{cfg.name}: a prefill of {s} rows cannot hold the "
                f"{nv}-row vision prefix")
        x = torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], dim=1)
    encoder_out = None
    if cfg.encoder_decoder:
        if mode == "decode":
            encoder_out = cache["encoder_out"]
        else:
            if encoder_frames is None:
                raise ValueError(
                    f"{cfg.name}: an encoder-decoder prefill needs "
                    "encoder_frames")
            encoder_out = _encode(cfg, params, encoder_frames)
            if out_cache is not None:
                out_cache["encoder_out"].copy_(encoder_out)
    n_pos = len(cfg.pattern)
    new_layers: list[list[dict]] = [[] for _ in range(n_pos)]
    dropped: list[torch.Tensor] = []
    topis: list[torch.Tensor] = []
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.pattern):
            p = _slice(params[f"pos{i}"], g)
            c = _slice(cache[f"pos{i}"], g) if mode == "decode" else None
            h = norm(x, p["norm_mixer"], cfg)
            clen = s if out_cache is not None else cache_len
            if spec.mixer == "attn":
                y, nc = attn_forward(
                    p["attn"], h, cfg, spec, mode=mode, positions=positions,
                    cache=c, pos=pos, cache_len=clen,
                    encoder_out=encoder_out,
                )
            elif spec.mixer == "mla":
                y, nc = mla_forward(
                    p["mla"], h, cfg, mode=mode, positions=positions,
                    cache=c, pos=pos, cache_len=clen,
                )
            else:
                y, nc = mamba_forward(
                    p["mamba"], h, cfg, mode=mode, cache=c, last=last,
                )
            if out_cache is not None:
                for name, leaf in nc.items():
                    dst = out_cache[f"pos{i}"][name][g]
                    ax = CACHE_SEQ_AXIS.get(name)
                    if ax is not None:
                        dst = dst.narrow(ax - 1, 0, s)
                    dst.copy_(leaf)
            elif mode != "decode":
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
                for name in new_layers[i][0]
            }
            for i in range(n_pos)
        }
        if encoder_out is not None:
            new_cache["encoder_out"] = encoder_out
    stats = {
        "dropped_frac": (
            torch.stack(dropped).mean() if dropped
            else torch.zeros((), device=dev)
        ),
        "topi": topis,
    }
    return norm(x, params["final_norm"], cfg), new_cache, stats


def _encode(cfg: ModelConfig, params: dict,
            frames: torch.Tensor) -> torch.Tensor:
    """Whisper's bidirectional encoder over the (stubbed) frame embeddings
    (b, encoder_seq, d): sinusoidal positions, then ``n_encoder_layers``
    pre-norm layers of non-causal attention (no cache) and a dense MLP,
    then the final norm (src/repro/models/model.py:205-228)."""
    enc = params["encoder"]
    s, d = frames.shape[1:]
    positions = torch.arange(s, device=frames.device)
    x = frames + sinusoid(positions, d).to(frames.dtype)
    spec = LayerSpec(mixer="attn", mlp="dense")
    for g in range(cfg.n_encoder_layers):
        p = _slice(enc["layers"], g)
        y, _ = attn_forward(
            p["attn"], norm(x, p["norm_mixer"], cfg), cfg, spec,
            mode="prefill", positions=positions, cache_len=s, causal=False,
        )
        x = x + y
        x = x + mlp_forward(p["mlp"], norm(x, p["norm_mlp"], cfg), cfg)
    return norm(x, enc["final_norm"], cfg)


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
    vision_embeds: torch.Tensor | None = None,
    encoder_frames: torch.Tensor | None = None,
) -> tuple:
    """Run the model: ``tokens`` (b, s) int — s == 1 in decode mode with
    ``pos`` the position of the new token, an int or a (b,) tensor of
    per-row positions.  Returns
    ``(logits (b, s, vocab_padded), cache[, moe_stats])``; in prefill the
    cache leaves are ``cache_len`` long, in decode ``cache`` is updated in
    place.  ``return_moe_stats`` appends ``{"dropped_frac": mean fraction
    of (token, choice) assignments the MoE capacity bound dropped, over
    the MoE layers, "topi": per-layer expert choices}``.
    ``vision_embeds`` / ``encoder_frames``: the frontend stubs' inputs."""
    x, new_cache, stats = _hidden(
        cfg, params, tokens, mode=mode, cache=cache, pos=pos,
        cache_len=cache_len, vision_embeds=vision_embeds,
        encoder_frames=encoder_frames,
    )
    ret = (_head(cfg, params, x), new_cache)
    return ret + (stats,) if return_moe_stats else ret


def prefill_step(
    cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
    cache_len: int, last: int | torch.Tensor,
    out_cache: dict | None = None,
    vision_embeds: torch.Tensor | None = None,
    encoder_frames: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict, dict]:
    """Prefill a bucket-padded batch: ``(logits at row last (b, vocab),
    cache, moe_stats)`` (``moe_stats`` as :func:`forward` returns it).
    ``last`` is the index of the last real prompt token (s - 1), so the
    bucket's pad positions never pick the first token, nor reach a Mamba
    layer's state: an int, or a (1,) integer device tensor that a
    captured prefill (launch/graphs.py) refills before each replay.  Both
    read the row with one ``index_select``, so the two give the same bits.
    ``out_cache`` (``cache_len`` long) receives the cache in place instead
    of fresh zero-padded leaves.  ``vision_embeds`` / ``encoder_frames``:
    the frontend stubs' inputs."""
    if not torch.is_tensor(last):
        last = torch.full((1,), last, dtype=torch.long,
                          device=params["embed"].device)
    x, cache, stats = _hidden(
        cfg, params, tokens, mode="prefill", cache=None, pos=None,
        cache_len=cache_len, out_cache=out_cache, last=last,
        vision_embeds=vision_embeds, encoder_frames=encoder_frames,
    )
    x_last = x.index_select(1, last.reshape(1)).squeeze(1)
    return _head(cfg, params, x_last), cache, stats


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
