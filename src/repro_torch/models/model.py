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
  * :func:`forward`     — logits for train/prefill/decode,
  * :func:`loss_fn`     — next-token cross entropy (+ the MoE aux loss),
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
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.partitioning import (
    AxisRules,
    PartitionSpec as P,
    constrain,
    is_dtensor,
)
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
    "make_cache", "abstract_cache", "cache_pspecs", "forward", "loss_fn",
    "prefill_step", "decode_step", "CACHE_SEQ_AXIS",
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


def cache_pspecs(
    cfg: ModelConfig, rules: AxisRules, batch: int, cache_len: int
) -> dict:
    """PartitionSpecs beside :func:`make_cache`'s tree, sanitized against
    the leaves' shapes (src/repro/models/model.py:104-143).  KV caches
    shard on the kv-head axis when it divides the model axis, otherwise on
    the sequence axis (the cache is the dominant memory and must shard on
    something model-sized)."""
    batch_ax = rules.rules.get("batch")
    model = rules.rules.get("ff")  # the TP axis name ("model") or None
    kv_ok = rules.rules.get("kv_heads_act") is not None
    out: dict = {}
    for p, spec in enumerate(cfg.pattern):
        defs = _cache_entry_defs(cfg, spec, batch, cache_len)
        if spec.mixer == "attn":
            raw = (P(None, batch_ax, model, None, None) if kv_ok
                   else P(None, batch_ax, None, model, None))
            entry = {"k": raw, "v": raw}
        elif spec.mixer == "mla":
            entry = {"ckv": P(None, batch_ax, model, None),
                     "k_rope": P(None, batch_ax, None, None)}
        else:  # mamba
            entry = {"conv": P(None, batch_ax, None, model),
                     "ssm": P(None, batch_ax, model, None)}
        out[f"pos{p}"] = {
            k: rules.sanitize(entry[k], (cfg.n_groups,) + defs[k][0])
            for k in entry
        }
    if cfg.encoder_decoder:
        out["encoder_out"] = rules.sanitize(
            P(batch_ax, None, None), (batch, cfg.encoder_seq, cfg.d_model))
    return out


def _embed(table: torch.Tensor, tokens: torch.Tensor,
           rules: AxisRules | None) -> torch.Tensor:
    """The (b, s, d) rows of ``tokens``.  Over a DTensor table sharded on
    the vocabulary each shard gathers the rows it holds and the rows are
    summed, as GSPMD partitions the reference's ``jnp.take``
    (src/repro/models/model.py:268): indexing the table would replicate
    it first (ROADMAP C16).  ``F.embedding`` leaves a masked partial whose
    mask is spent by its first reduction, and the stream is read twice
    (the norm and the residual add), so the partial is reduced here, at
    once, into the residual stream's layout (decode's one row keeps its
    sequence replicated)."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Replicate, Shard

    # An FSDP table is also sharded over "data", which shards the tokens'
    # batch: the model axis's shard of the table is gathered over it
    # first, so that the masked partial's mask and the rows it masks have
    # one batch layout.
    table = table.redistribute(table.device_mesh, [
        p if isinstance(p, Shard) and p.dim == 0 else Replicate()
        for p in table.placements])
    x = torch.nn.functional.embedding(tokens, table)
    return constrain(x, rules, "batch", "seq", None)


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
    remat: bool = True,
    rules: AxisRules | None = None,
) -> tuple[torch.Tensor, dict | None, dict]:
    """Embedding through the final norm: (hidden (b, s, d), cache,
    moe_stats).  ``moe_stats`` holds ``aux``, the MoE load-balance loss
    summed over the MoE layers and divided by ``n_layers``, the mean
    ``dropped_frac`` over the MoE layers (device scalars; 0 without MoE
    layers) and, outside train mode, ``topi``, each MoE layer's (b, s, k)
    expert choices in layer order.  Train mode emits no cache and, with
    ``remat``, recomputes each group in the backward pass
    (:func:`_train_layers`).  A prefill with
    ``out_cache`` (a :func:`make_cache`-shaped tree) writes each layer's
    k/v (ckv/k_rope) into its first s rows in place, and its Mamba state
    whole, and its ``encoder_out`` whole, and returns it; the rows past s
    keep what they held (every decode read is masked past ``pos``).
    ``last`` ((1,) integer tensor) is the prefill's last real row, whose
    state the Mamba layers keep.  ``vision_embeds`` and ``encoder_frames``
    are the frontend stubs' inputs (module docstring).  ``rules`` pins
    the residual stream's layout between layers (a no-op on plain
    tensors)."""
    b, s = tokens.shape
    x = _embed(params["embed"], tokens, rules)
    if cfg.embed_scale:
        # Gemma's sqrt(d) scale, in f32 then cast (model.py:269-270).
        x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
    dev = x.device
    # RoPE positions: (s,) in prefill, (b, 1) in decode.  Decode has one
    # path: an int ``pos`` is every row at that position.
    uniform_pos = None  # the batch's one decode position, if it has one
    if mode != "decode":
        positions = torch.arange(s, device=dev)
    else:
        if not torch.is_tensor(pos):
            uniform_pos = pos
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
    if mode != "decode":
        x = constrain(x, rules, "batch", "seq", None)
    encoder_out = None
    if cfg.encoder_decoder:
        if mode == "decode":
            encoder_out = cache["encoder_out"]
        else:
            if encoder_frames is None:
                raise ValueError(
                    f"{cfg.name}: an encoder-decoder prefill needs "
                    "encoder_frames")
            encoder_out = _encode(
                cfg, params, encoder_frames,
                mode="train" if mode == "train" else "prefill", rules=rules)
            if out_cache is not None:
                out_cache["encoder_out"].copy_(encoder_out)
    if mode == "train":
        x, stats = _train_layers(cfg, params, x, positions, encoder_out,
                                 remat, rules)
        return norm(x, params["final_norm"], cfg), None, stats
    n_pos = len(cfg.pattern)
    new_layers: list[list[dict]] = [[] for _ in range(n_pos)]
    auxes: list[torch.Tensor] = []
    dropped: list[torch.Tensor] = []
    topis: list[torch.Tensor] = []
    clen = s if out_cache is not None else cache_len
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.pattern):
            c = _slice(cache[f"pos{i}"], g) if mode == "decode" else None
            x, nc, moe = _apply_layer(
                cfg, spec, _slice(params[f"pos{i}"], g), x, mode=mode,
                positions=positions, cache=c, pos=pos, cache_len=clen,
                last=last, encoder_out=encoder_out, rules=rules,
                uniform_pos=uniform_pos,
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
            if moe is not None:
                auxes.append(moe[0])
                dropped.append(moe[1])
                topis.append(moe[2])
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
    stats = _moe_stats(cfg, auxes, dropped, dev)
    stats["topi"] = topis
    return norm(x, params["final_norm"], cfg), new_cache, stats


def _gather(h: torch.Tensor, mode: str,
            rules: AxisRules | None) -> torch.Tensor:
    """A sublayer's input with its whole sequence, outside decode
    (Megatron-SP's gather point, which the reference pins before its
    train-mode mixers and its MoE routing, src/repro/models/layers.py:
    384, :1007): the projections then flatten only (b, s) with s
    unsharded, where torch 2.11's DTensor refuses to flatten a sharded
    sequence under a sharded batch."""
    if mode == "decode":
        return h
    return constrain(h, rules, "batch", None, None)


def _scatter(y: torch.Tensor, mode: str,
             rules: AxisRules | None) -> torch.Tensor:
    """A sublayer's output, a partial sum of a row-parallel projection
    over a mesh, reduced into the residual stream's layout ``(batch, seq,
    None)`` before the residual add, outside decode.  Left to DTensor,
    the partial rode the add into the next sublayer: whisper's encoder
    reduced it at the MLP's activation onto its 1,500 frames sharded
    unevenly 16 ways, a padded shard the next matmul could not view
    (ROADMAP C18); and the add's backward handed the projection a
    (batch, seq)-sharded cotangent to flatten, which torch 2.11's DTensor
    refuses.  Reduced here, the backward gathers the sequence first."""
    if mode == "decode":
        return y
    return constrain(y, rules, "batch", "seq", None)


def _apply_layer(
    cfg: ModelConfig, spec: LayerSpec, p: dict, x: torch.Tensor, *,
    mode: str, positions: torch.Tensor, cache: dict | None = None,
    pos: torch.Tensor | None = None, cache_len: int = 0,
    last: torch.Tensor | None = None,
    encoder_out: torch.Tensor | None = None, causal: bool = True,
    rules: AxisRules | None = None, uniform_pos: int | None = None,
) -> tuple[torch.Tensor, dict | None, tuple | None]:
    """One pre-norm layer (src/repro/models/model.py:145-201): ``(x, the
    mixer's cache, (aux, dropped_frac, topi) of an MoE MLP or None)``.

    Outside decode, over a mesh, each sublayer reads the whole sequence
    (:func:`_gather`) and its output joins the sequence-parallel residual
    stream reduced (:func:`_scatter`).
    """
    h = _gather(norm(x, p["norm_mixer"], cfg), mode, rules)
    if spec.mixer == "attn":
        y, nc = attn_forward(
            p["attn"], h, cfg, spec, mode=mode, positions=positions,
            cache=cache, pos=pos, cache_len=cache_len, causal=causal,
            encoder_out=encoder_out, rules=rules, uniform_pos=uniform_pos,
        )
    elif spec.mixer == "mla":
        y, nc = mla_forward(
            p["mla"], h, cfg, mode=mode, positions=positions, cache=cache,
            pos=pos, cache_len=cache_len, rules=rules,
        )
    else:
        y, nc = mamba_forward(p["mamba"], h, cfg, mode=mode, cache=cache,
                              last=last, rules=rules)
    x = x + _scatter(y, mode, rules)
    moe = None
    if spec.mlp == "dense":
        x = x + _scatter(mlp_forward(
            p["mlp"], _gather(norm(x, p["norm_mlp"], cfg), mode, rules),
            cfg, rules=rules), mode, rules)
    elif spec.mlp == "moe":
        y, aux, drop, topi = moe_forward(
            p["moe"], _gather(norm(x, p["norm_mlp"], cfg), mode, rules),
            cfg, mode=mode, rules=rules)
        x = x + _scatter(y, mode, rules)
        moe = (aux, drop, topi)
    if mode != "decode":
        # Decode streams are tiny (s = 1) and stay unpinned, as in the
        # reference.
        x = constrain(x, rules, "batch", "seq", None)
    return x, nc, moe


def _moe_stats(cfg: ModelConfig, auxes: list, dropped: list, dev) -> dict:
    """The load-balance loss summed over the MoE layers and divided by
    ``cfg.n_layers`` (all layers, as the reference divides,
    src/repro/models/model.py:366), and the mean ``dropped_frac`` over the
    MoE layers; device scalars, 0 without MoE layers.  ``auxes`` and
    ``dropped`` hold each layer's scalar, or each group's vector of them,
    in layer order."""
    if not auxes:
        zero = torch.zeros((), device=dev)
        return {"aux": zero, "dropped_frac": zero}
    aux = torch.cat([a.reshape(-1) for a in auxes])
    return {
        "aux": aux.sum() / max(cfg.n_layers, 1),
        "dropped_frac": torch.cat([d.reshape(-1) for d in dropped]).mean(),
    }


def _train_layers(
    cfg: ModelConfig, params: dict, x: torch.Tensor,
    positions: torch.Tensor, encoder_out: torch.Tensor | None, remat: bool,
    rules: AxisRules | None = None,
) -> tuple[torch.Tensor, dict]:
    """The decoder stack in train mode: ``(x, {"aux", "dropped_frac"})``.
    With ``remat`` each group runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint(nothing_saveable)`` around its scanned
    group body, model.py:327-330): only the group's input is kept, and
    the backward pass recomputes the rest.  Each stacked leaf is unbound
    once, so its gradient is stacked once, not scattered per group."""
    layers = [_unbind(params[f"pos{i}"], cfg.n_groups)
              for i in range(len(cfg.pattern))]
    n_moe = sum(spec.mlp == "moe" for spec in cfg.pattern)

    def group(x, g):
        moes = []
        for i, spec in enumerate(cfg.pattern):
            x, _, moe = _apply_layer(
                cfg, spec, layers[i][g], x, mode="train",
                positions=positions, encoder_out=encoder_out, rules=rules,
            )
            moes += [] if moe is None else [moe[:2]]
        if not moes:
            return x
        aux, drop = zip(*moes)
        return x, torch.stack(aux), torch.stack(drop)

    auxes, dropped = [], []
    for g in range(cfg.n_groups):
        out = (checkpoint(group, x, g, use_reentrant=False) if remat
               else group(x, g))
        if n_moe:
            x, aux, drop = out
            auxes.append(aux)
            dropped.append(drop)
        else:
            x = out
    return x, _moe_stats(cfg, auxes, dropped, x.device)


def _encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
            mode: str = "prefill",
            rules: AxisRules | None = None) -> torch.Tensor:
    """Whisper's bidirectional encoder over the (stubbed) frame embeddings
    (b, encoder_seq, d): sinusoidal positions, then ``n_encoder_layers``
    pre-norm layers of non-causal attention (no cache) and a dense MLP,
    then the final norm (src/repro/models/model.py:205-228).  In a
    prefill its attention dispatches through an installed session; in
    ``mode="train"`` it stays inline, where autograd reaches it."""
    enc = params["encoder"]
    s, d = frames.shape[1:]
    positions = torch.arange(s, device=frames.device)
    x = frames + sinusoid(positions, d).to(frames.dtype)
    spec = LayerSpec(mixer="attn", mlp="dense")
    layers = (_unbind(enc["layers"], cfg.n_encoder_layers) if mode == "train"
              else [_slice(enc["layers"], g)
                    for g in range(cfg.n_encoder_layers)])
    for p in layers:
        x, _, _ = _apply_layer(cfg, spec, p, x, mode=mode,
                               positions=positions, cache_len=s,
                               causal=False, rules=rules)
    return norm(x, enc["final_norm"], cfg)


def _slice(tree: dict, g: int) -> dict:
    """Group ``g`` of a stacked tree: views, so decode writes land in the
    stacked cache."""
    return {
        k: _slice(v, g) if isinstance(v, dict) else v[g]
        for k, v in tree.items()
    }


def _unbind(tree: dict, n: int) -> list[dict]:
    """The ``n`` groups of a stacked tree, each leaf unbound once: under
    autograd one ``unbind`` gathers the groups' gradients with one stack,
    where ``n`` separate ``v[g]`` views would each scatter into a zeroed
    copy of the whole stack."""
    flat = {k: _unbind(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}
    return [{k: v[g] for k, v in flat.items()} for g in range(n)]


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor,
          rules: AxisRules | None = None) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if x.ndim == 3:  # every row (train): the whole sequence, as _gather
        x = constrain(x, rules, "batch", None, None)
    logits = x @ head
    # (b, s, vocab), or a prefill's last row (b, vocab).
    logits = constrain(logits, rules, "batch",
                       *(None,) * (logits.ndim - 2), "vocab")
    if cfg.logit_softcap is not None:
        c = cfg.logit_softcap
        logits = (torch.tanh(logits.float() / c) * c).to(logits.dtype)
    if cfg.vocab_padded != cfg.vocab:
        # Mask the padding columns so argmax and softmax never see them.
        # In place, and safe under autograd: no backward saves this tensor
        # (the matmul saves its inputs, tanh its own output, which the
        # scale by c copies), and the masked columns get a zero gradient,
        # as under the reference's ``where``.  Over DTensors it is the
        # reference's ``where`` (DTensor has no rule for the slice fill).
        if is_dtensor(logits):
            col = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(col < cfg.vocab, logits, -1e30)
        else:
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
    remat: bool = True,
    rules: AxisRules | None = None,
) -> tuple:
    """Run the model: ``tokens`` (b, s) int — s == 1 in decode mode with
    ``pos`` the position of the new token, an int or a (b,) tensor of
    per-row positions.  Returns
    ``(logits (b, s, vocab_padded), cache[, moe_stats])``; in prefill the
    cache leaves are ``cache_len`` long, in decode ``cache`` is updated in
    place, in train mode the cache is None and ``remat`` recomputes each
    group in the backward pass.  ``return_moe_stats`` appends ``{"aux":
    the MoE load-balance loss over ``n_layers``, "dropped_frac": mean
    fraction of (token, choice) assignments the MoE capacity bound
    dropped, over the MoE layers, "topi": per-layer expert choices (not
    in train mode)}``.  ``vision_embeds`` / ``encoder_frames``: the
    frontend stubs' inputs.  ``rules`` (an ``AxisRules``) lays out the
    activations of a forward over DTensor parameters and inputs (the
    reference's sharding constraints; no-ops on plain tensors)."""
    x, new_cache, stats = _hidden(
        cfg, params, tokens, mode=mode, cache=cache, pos=pos,
        cache_len=cache_len, vision_embeds=vision_embeds,
        encoder_frames=encoder_frames, remat=remat, rules=rules,
    )
    ret = (_head(cfg, params, x, rules), new_cache)
    return ret + (stats,) if return_moe_stats else ret


def loss_fn(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    *,
    aux_weight: float = 0.01,
    rules: AxisRules | None = None,
    **fwd_kwargs,
) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross entropy in float32 plus ``aux_weight`` times
    the MoE load-balance loss (src/repro/models/model.py:372-400): ``(total,
    {"xent", "aux", "dropped_frac"})``, every value a device scalar.
    ``fwd_kwargs`` go to :func:`forward` in train mode (``remat``,
    ``vision_embeds``, ``encoder_frames``).  Over DTensors the loss is a
    replicated DTensor scalar."""
    logits, _, stats = forward(
        cfg, params, tokens, mode="train", return_moe_stats=True,
        rules=rules, **fwd_kwargs,
    )
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    # DTensor has no working rule for a gather along a sharded vocab axis
    # (its masked partial fails to reduce), so the labels' logits are
    # gathered from a vocab-replicated view.
    lf = constrain(lf, rules, "batch", None, None)
    ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    xent = (lse - ll).mean()
    aux = stats["aux"]
    return xent + aux_weight * aux, {
        "xent": xent, "aux": aux, "dropped_frac": stats["dropped_frac"],
    }


def prefill_step(
    cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
    cache_len: int, last: int | torch.Tensor,
    out_cache: dict | None = None,
    vision_embeds: torch.Tensor | None = None,
    encoder_frames: torch.Tensor | None = None,
    rules: AxisRules | None = None,
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
        rules=rules,
    )
    x_last = x.index_select(1, last.reshape(1)).squeeze(1)
    return _head(cfg, params, x_last, rules), cache, stats


def decode_step(
    cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
    pos: int | torch.Tensor, *, rules: AxisRules | None = None,
) -> tuple[torch.Tensor, dict, dict]:
    """One decode token: ``(logits (b, vocab), cache, moe_stats)``; ``pos``
    is one position for the batch or a (b,) tensor of per-row ones."""
    x, cache, stats = _hidden(
        cfg, params, tokens, mode="decode", cache=cache, pos=pos,
        cache_len=0, rules=rules,
    )
    return _head(cfg, params, x[:, 0], rules), cache, stats
