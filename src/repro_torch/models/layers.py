"""The attention-decoder layers (counterpart of src/repro/models/layers.py).

Every mixer/MLP is a plain function ``(params, x, ...) -> y`` on tensors,
in two modes:

  * ``prefill`` — the full (bucket-padded) sequence, emitting a decode cache
    of length ``cache_len``,
  * ``decode``  — one new token against the cache at the scalar ``pos``.

With a :mod:`repro_torch.vortex` session installed, prefill attention and
each decode token's attention are served by the engine (the lattice picks
the kernel's tiles; on the card they launch the hand-written kernels),
exactly where the reference routes them; without one the plain chunked
attention runs inline.  The projections are plain matmuls, as the JAX
package leaves them to XLA.
"""
from __future__ import annotations

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


def _decode_attend(
    q: torch.Tensor,        # (b, H, 1, hd)
    k_cache: torch.Tensor,  # (b, KV, S, hd)
    v_cache: torch.Tensor,  # (b, KV, S, dv)
    pos: int,               # index of the new token (whole batch)
    window: int | None,
    softcap: float | None,
    scale: float,
) -> torch.Tensor:
    b, hq, _, hd = q.shape
    _, hkv, S, _ = k_cache.shape
    group = hq // hkv

    # Engine-served decode: the query dispatches through the kv_len-masked
    # decode workload at the (bucketed) cache length S, with the valid row
    # count as a runtime scalar, so cache tails past the last written token
    # may hold anything.  The inline math below serves sessionless callers
    # and the shapes the workload does not cover (dv != hd, a non-default
    # scale).  The reference's static window slice is an optimization of
    # later work: the window mask alone gives the same result.
    engine = session.installed_engine()
    if (
        engine is not None
        and v_cache.shape[-1] == hd
        and abs(scale - hd ** -0.5) < 1e-12
    ):
        return engine.dispatch(
            "decode_attention", q, k_cache, v_cache, pos + 1,
            window=window, softcap=softcap,
        ).to(q.dtype)

    # Inline: masks SCORES only, so cache tails must be finite here.
    qf = q.float().reshape(b, hkv, group, hd)
    s = torch.einsum("bkgd,bksd->bkgs", qf, k_cache.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    k_pos = torch.arange(S, device=q.device)
    mask = k_pos <= pos
    if window is not None:
        mask = mask & (k_pos > pos - window)
    s = torch.where(mask[None, None, None, :], s, -1e30)
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
    pos: int | None = None,
    cache_len: int = 0,
) -> tuple[torch.Tensor, dict]:
    """GQA attention with RoPE, sliding window and logit softcap.

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
        # positions: (s,) absolute positions — arange(s) in prefill, the
        # one-element [pos] in decode.
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        cos, sin = cos[None, None], sin[None, None]  # (1, 1, s, hd/2)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    scale = hd ** -0.5
    if mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and a position")
        # In place: the cache is this request's own (leased) buffer.
        cache["k"][:, :, pos:pos + 1] = k.to(cache["k"].dtype)
        cache["v"][:, :, pos:pos + 1] = v.to(cache["v"].dtype)
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
            "k": F.pad(k, (0, 0, 0, pad)),
            "v": F.pad(v, (0, 0, 0, pad)),
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
