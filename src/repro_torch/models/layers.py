"""The attention-decoder layers (counterpart of src/repro/models/layers.py).

Attention, dense MLPs and top-k routed MoE.  Every mixer/MLP is a plain
function ``(params, x, ...) -> y`` on tensors, in two modes:

  * ``prefill`` — the full (bucket-padded) sequence, emitting a decode cache
    of length ``cache_len``,
  * ``decode``  — one new token against the cache at ``pos``: one position
    for the batch, or a (b,) vector of per-row positions (continuous
    batching).

With a :mod:`repro_torch.vortex` session installed, prefill attention and
each decode token's attention are served by the engine (the lattice picks
the kernel's tiles; on the card they launch the hand-written kernels),
exactly where the reference routes them; without one the plain chunked
attention runs inline.  Likewise each MoE layer serves its experts through
three ``grouped_gemm`` dispatches (one launch per projection for all
experts) under a session, and through inline einsums without one.  The
dense projections are plain matmuls, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import chunked_attention
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.vortex import session

__all__ = [
    "rmsnorm",
    "layernorm",
    "norm",
    "rope_tables",
    "apply_rope",
    "attn_forward",
    "mlp_forward",
    "route",
    "moe_capacity",
    "moe_forward",
    "ATTN_CHUNK",
]

# KV-chunk length of the inline (sessionless) online-softmax attention.
ATTN_CHUNK = 1024


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w


def norm(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rmsnorm(x, w) if cfg.norm == "rmsnorm" else layernorm(x, w)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_tables(
    positions: torch.Tensor, dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., dim/2) cos/sin tables for integer positions."""
    half = dim // 2
    freq = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device)
        / half
    )
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Rotate pairs (split-half convention). x: (..., seq, dim);
    cos/sin: (seq, dim/2) broadcastable."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    o1 = xf1 * cos - xf2 * sin
    o2 = xf2 * cos + xf1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    # Contiguous: the kernels take dense (b, h, s, hd) tensors.
    return x.reshape(b, s, n, -1).transpose(1, 2).contiguous()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def _window_slice(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    window: int,
):
    """The last ``window`` cache rows up to each row's ``pos`` (the
    reference's static window slice, src/repro/models/layers.py:185-215,
    per row): ``(k, v, start)``, k/v ``(b, KV, window, hd)``, ``start`` the
    (b,) absolute position of each row's row 0.

    A gather copy of ``window`` rows per (row, kv head): the kernels take
    dense caches.
    """
    b, hkv, S, _ = k_cache.shape
    start = (pos - window + 1).clamp(0, S - window)
    idx = start[:, None] + torch.arange(window, device=pos.device)
    idx = idx[:, None, :, None].long()
    k = torch.gather(k_cache, 2, idx.expand(b, hkv, window, k_cache.shape[-1]))
    v = torch.gather(v_cache, 2, idx.expand(b, hkv, window, v_cache.shape[-1]))
    return k, v, start


def _decode_attend(
    q: torch.Tensor,        # (b, H, 1, hd)
    k_cache: torch.Tensor,  # (b, KV, S, hd)
    v_cache: torch.Tensor,  # (b, KV, S, dv)
    pos: torch.Tensor,      # (b,) index of each row's new token
    window: int | None,
    softcap: float | None,
    scale: float,
) -> torch.Tensor:
    b, hq, _, hd = q.shape
    _, hkv, S, _ = k_cache.shape
    group = hq // hkv

    # A sliding-window layer reads only the last ``window`` positions: once
    # the cache is longer than twice the window, slice them out and rebase
    # the positions (as the reference does), so the decode dispatch sees the
    # reference's extent and bucket.
    base = 0
    if window is not None and S > 2 * window:
        k_cache, v_cache, base = _window_slice(k_cache, v_cache, pos, window)
        S = window

    # Engine-served decode: the query dispatches through the kv_len-masked
    # decode workload at the (bucketed) cache length S, with the valid row
    # count as a runtime (b,) extent -- rows may be at mixed progress, one
    # launch for the whole batch -- so cache tails past the last written
    # token may hold anything.  The inline math below serves sessionless
    # callers and the shapes the workload does not cover (dv != hd, a
    # non-default scale).
    engine = session.installed_engine()
    if (
        engine is not None
        and v_cache.shape[-1] == hd
        and abs(scale - hd ** -0.5) < 1e-12
    ):
        return engine.dispatch(
            "decode_attention", q, k_cache, v_cache, pos - base + 1,
            window=window, softcap=softcap,
        ).to(q.dtype)

    # Inline: masks SCORES only, so cache tails must be finite here.
    qf = q.float().reshape(b, hkv, group, hd)
    s = torch.einsum("bkgd,bksd->bkgs", qf, k_cache.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    k_pos = torch.arange(S, device=q.device)[None] + torch.as_tensor(
        base, device=q.device).reshape(-1, 1)          # (b or 1, S)
    p_ = pos[:, None]
    mask = k_pos <= p_
    if window is not None:
        mask = mask & (k_pos > p_ - window)
    s = torch.where(mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return out.reshape(b, hq, 1, -1).to(q.dtype)


def attn_forward(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    spec: LayerSpec,
    *,
    mode: str,
    positions: torch.Tensor,
    cache: dict | None = None,
    pos: torch.Tensor | None = None,
    cache_len: int = 0,
) -> tuple[torch.Tensor, dict]:
    """GQA attention with RoPE, sliding window and logit softcap.

    ``positions`` are the RoPE positions: ``(s,)`` in prefill, ``(b, 1)``
    in decode.  ``pos`` is the (b,) decode position of each row.

    Returns ``(y, cache)``: in prefill the emitted k/v are padded to
    ``cache_len``; in decode the new token's k/v row is written INTO
    ``cache`` in place (the counterpart of the reference's
    ``dynamic_update_slice``) and the same dict comes back.
    """
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    q = _split_heads(x @ p["wq"], H)
    k = _split_heads(x @ p["wk"], KV)
    v = _split_heads(x @ p["wv"], KV)

    if cfg.use_rope:
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        if positions.ndim == 2:
            # Decode positions (b, 1): tables (b, 1, hd/2) lifted to
            # (b, 1, 1, hd/2), so every row rotates at its own position.
            cos, sin = cos[:, None], sin[:, None]
        else:
            cos, sin = cos[None, None], sin[None, None]  # (1, 1, s, hd/2)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    scale = hd ** -0.5
    if mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and a position")
        # In place: the cache is this request's own (leased) buffer, or the
        # scheduler's shared one.
        # Each row's k/v lands at its own position: the (rows, pos) index
        # pairs select one cache row per batch row.
        rows = torch.arange(b, device=pos.device)
        at = pos.long()
        cache["k"][rows, :, at] = k[:, :, 0].to(cache["k"].dtype)
        cache["v"][rows, :, at] = v[:, :, 0].to(cache["v"].dtype)
        out = _decode_attend(
            q, cache["k"], cache["v"], pos, spec.window, cfg.attn_softcap,
            scale,
        )
        new_cache = cache
    else:
        engine = session.installed_engine()
        if engine is not None:
            # Dynamic-seq serving path: the session engine selects
            # (block_q, block_k) from the scored lattice for this seq.
            out = engine.dispatch(
                "attention", q, k, v, causal=True, window=spec.window,
                softcap=cfg.attn_softcap,
            )
        else:
            out = chunked_attention(
                q, k, v, causal=True, window=spec.window,
                softcap=cfg.attn_softcap, chunk=ATTN_CHUNK,
            )
        pad = cache_len - s
        new_cache = {
            "k": F.pad(k, (0, 0, 0, pad)) if pad else k,
            "v": F.pad(v, (0, 0, 0, pad)) if pad else v,
        }
    y = _merge_heads(out) @ p["wo"]
    return y, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _glu_act(
    cfg: ModelConfig, h: torch.Tensor, g: torch.Tensor | None
) -> torch.Tensor:
    if cfg.act == "swiglu":
        return F.silu(g) * h
    if cfg.act == "geglu":
        return F.gelu(g, approximate="tanh") * h
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(h, approximate="tanh")


def mlp_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = x @ p["w_in"]
    g = x @ p["w_gate"] if "w_gate" in p else None
    return _glu_act(cfg, h, g) @ p["w_out"]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_capacity(cfg: ModelConfig, s: int) -> int:
    """Rows per expert slab for a routing group of ``s`` tokens:
    ``max(1, ceil(s * top_k * capacity_factor / num_experts))``."""
    m = cfg.moe
    return max(1, int(math.ceil(s * m.top_k * m.capacity_factor
                                / m.num_experts)))


def route(
    p: dict, x: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing in f32: ``(probs (b, s, E), topw (b, s, k) renormalised
    to sum 1, topi (b, s, k))``, choices in descending probability."""
    probs = torch.softmax(
        torch.einsum("gtd,de->gte", x.float(), p["router"].float()), dim=-1
    )
    topw, topi = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, topw / topw.sum(dim=-1, keepdim=True), topi


def _expert_ffn(
    p: dict, buf: torch.Tensor, cfg: ModelConfig, counts: torch.Tensor
) -> torch.Tensor:
    """buf: (g, E, C, d) -> (g, E, C, d) through the per-expert FFNs.

    ``counts`` (g, E) int32 is each expert slab's TRUE row count; rows past
    it are routing pad (zero-filled by :func:`moe_forward`).  With an
    engine session installed the three projections are three
    ``grouped_gemm`` dispatches, each ONE launch for all g*E slabs with the
    capacity as the bucketed extent and the counts riding in as the
    device-side extent vector.  Without one, inline einsums.
    """
    engine = session.installed_engine()
    if engine is not None:
        g, E, C, d = buf.shape
        # Expert-major group layout (g, E, C, d) -> (E*g, C, d): the r = g
        # consecutive groups of each expert share one weight-stack entry
        # (the grouped_gemm contract: weight index = group // r).
        xs = buf.transpose(0, 1).reshape(E * g, C, d)
        cnt = counts.transpose(0, 1).reshape(E * g)
        h = engine.dispatch("grouped_gemm", xs, p["w_in"], cnt)
        gate = (
            engine.dispatch("grouped_gemm", xs, p["w_gate"], cnt)
            if "w_gate" in p else None
        )
        h = _glu_act(cfg, h, gate)
        out = engine.dispatch("grouped_gemm", h, p["w_out"], cnt)
        return out.reshape(E, g, C, -1).transpose(0, 1)

    h = torch.einsum("gecd,edf->gecf", buf, p["w_in"])
    gate = (
        torch.einsum("gecd,edf->gecf", buf, p["w_gate"])
        if "w_gate" in p else None
    )
    h = _glu_act(cfg, h, gate)
    return torch.einsum("gecf,efd->gecd", h, p["w_out"])


def moe_forward(
    p: dict, x: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routed MoE with sort-based, capacity-bounded dispatch.

    Each batch row is a routing group.  Every expert has capacity
    ``C = moe_capacity(cfg, s)`` rows and admits its
    first C assignments in flat (token, choice) order (a stable argsort
    keeps that order); a dropped assignment contributes exactly 0 to its
    token's combine, with no renormalisation over the kept experts.  The
    dispatch is gather-only, as in the reference.  Returns ``(y, aux,
    dropped_frac, topi)``: the Switch load-balance loss, the fraction of
    assignments the capacity bound dropped, and the (b, s, k) expert
    choices — every statistic a device tensor, never read on the host.
    """
    m = cfg.moe
    b, s, d = x.shape
    E, k = m.num_experts, m.top_k
    C = moe_capacity(cfg, s)
    dev = x.device
    probs, topw, topi = route(p, x, cfg)

    # Aux loss (Switch): E * sum_e f_e * P_e over all tokens.
    f_e = F.one_hot(topi[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(f_e * probs.mean(dim=(0, 1)))

    S = s * k
    flat_e = topi.reshape(b, S)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # sorted pos -> flat
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(E, device=dev)
    # Start of each expert's segment in the sorted order.
    first = torch.searchsorted(
        sorted_e, experts.expand(b, E).contiguous(), right=False
    )                                                     # (b, E)
    # Forward map: slot (e, c) <- sorted position first[e] + c.
    p_grid = first[:, :, None] + torch.arange(C, device=dev)  # (b, E, C)
    p_clip = p_grid.clamp(max=S - 1).reshape(b, E * C)
    e_at_p = torch.gather(sorted_e, 1, p_clip).reshape(b, E, C)
    valid = (p_grid < S) & (e_at_p == experts[None, :, None])
    token_idx = torch.gather(order, 1, p_clip) // k       # (b, E*C)
    buf = torch.gather(x, 1, token_idx[..., None].expand(b, E * C, d))
    buf = torch.where(valid.reshape(b, E * C, 1), buf, 0).reshape(b, E, C, d)
    # ``valid`` is a prefix of each slab, so its sum is the slab's extent.
    counts = valid.sum(dim=-1, dtype=torch.int32)         # (b, E)

    out_flat = _expert_ffn(p, buf, cfg, counts).reshape(b, E * C, d)

    # Return map: flat position f sits at sorted position inv[f], in slot
    # (flat_e[f], inv[f] - first[flat_e[f]]).
    inv = torch.argsort(order, dim=-1)
    pos_in_e = inv - torch.gather(first, 1, flat_e)
    kept = pos_in_e < C
    dropped_frac = 1.0 - kept.float().mean()
    out_idx = (flat_e * C + pos_in_e).clamp(max=E * C - 1)
    y_tok = torch.gather(out_flat, 1, out_idx[..., None].expand(b, S, d))
    y_tok = torch.where(kept[..., None], y_tok, 0).float()
    y_tok = y_tok * topw.reshape(b, S)[..., None]
    y = y_tok.reshape(b, s, k, d).sum(dim=2).to(x.dtype)

    if m.num_shared:
        h = x @ p["shared_in"]
        gate = x @ p["shared_gate"] if "shared_gate" in p else None
        y = y + _glu_act(cfg, h, gate) @ p["shared_out"]
    return y, aux, dropped_frac, topi
