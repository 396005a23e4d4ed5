"""Plain float32 forward of the served decoders (granite-moe-1b-a400m and
phi4-mini-3.8b as the configuration files state them): no kernel, no
cache, no batching, nothing of the program.

A pre-norm decoder: RMSNorm (epsilon ``norm_eps``), grouped-query
attention with rotary positions over the whole head (split halves,
``rope_theta``) and scores scaled by head_dim^-0.5, SwiGLU MLP
(``silu(x W_gate) * (x W_in) W_out``) or a routed mixture of SwiGLU
experts, final RMSNorm, tied LM head over the true vocabulary.

Experts: a float32 softmax over the router's logits, the top-k by
probability renormalised to sum 1.  A prompt's tokens route as one group
(the configuration's departure from the dropless model): each expert
admits the first ``C = ceil(group_len * top_k * capacity_factor / E)``
of its (token, choice) assignments in token-then-choice order, where
``group_len`` is the prompt's length padded to the serving bucket, and a
dropped assignment adds 0, with no renormalisation.  Padding positions
come after every prompt token, so they never displace one.  A token fed
back after the prompt routes alone and drops nothing.

:func:`logits` runs a sequence teacher-forced: prompt then the tokens the
program served, and returns the logits at the positions that predicted
each served token.  ``weights`` are the served weights (any dtype; each
is taken to float32 when used).  With ``weight_fmt="fp8"`` every
matrix product of the layers and the head takes both operands rounded to
float8 e4m3 under per-tensor scales, as an fp8 GEMM would: the control.
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _q(t: torch.Tensor, fmt: str) -> torch.Tensor:
    """An operand in float32, or rounded to float8 e4m3 under a
    per-tensor scale."""
    t = t.float()
    if fmt == "fp8":
        return _fp8(t)
    if fmt != "f32":
        raise ValueError(f"unknown weight format {fmt!r}")
    return t


def _mm(x: torch.Tensor, w: torch.Tensor, fmt: str) -> torch.Tensor:
    return _q(x, fmt) @ _q(w, fmt)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (heads, T, hd), rotated at positions 0..T-1."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(x.shape[1], dtype=torch.float32,
                       device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, chunk: int = 1024) -> torch.Tensor:
    """Causal softmax attention, q (H, T, hd), k/v (KV, T, hd), in blocks
    of ``chunk`` queries."""
    h, t, hd = q.shape
    group = h // k.shape[0]
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    out = torch.empty_like(q)
    keys = torch.arange(t, device=q.device)
    for i in range(0, t, chunk):
        j = min(t, i + chunk)
        s = (q[:, i:j] @ k[:, :j].transpose(1, 2)) * hd ** -0.5
        mask = keys[None, :j] > torch.arange(i, j, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[:, i:j] = torch.softmax(s, dim=-1) @ v[:, :j]
    return out


def moe(x: torch.Tensor, p: dict, model: dict, n_group: int,
        group_len: int, fmt: str) -> torch.Tensor:
    """Routed experts over x (T, d); the first ``n_group`` tokens are the
    prompt's group with capacity from ``group_len``.  Every expert runs on
    every token and a token keeps the outputs of the experts it routed to
    and was admitted by, weighted: the same products as running each
    expert on its own tokens."""
    m = model["moe"]
    e, k = m["num_experts"], m["top_k"]
    t, d = x.shape
    probs = torch.softmax(x @ p["router"].float(), dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True)
    kept = torch.ones_like(topw, dtype=torch.bool)
    if n_group:
        cap = max(1, math.ceil(group_len * k * m["capacity_factor"] / e))
        flat = topi[:n_group].reshape(-1)
        onehot = torch.nn.functional.one_hot(flat, e)
        rank = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
        kept[:n_group] = (rank < cap).reshape(n_group, k)
    comb = torch.zeros((t, e), dtype=torch.float32, device=x.device)
    comb.scatter_(1, topi, topw * kept)
    fe = p["w_in"].shape[-1]
    xq = _q(x, fmt)

    def up(w):  # (E, d, fe) -> (T, E, fe)
        w = _q(w.permute(1, 0, 2).reshape(d, e * fe), fmt)
        return (xq @ w).reshape(t, e, fe)

    h = torch.nn.functional.silu(up(p["w_gate"])) * up(p["w_in"])
    out = torch.einsum("tef,efd->ted", _q(h, fmt), _q(p["w_out"], fmt))
    return (out * comb[..., None]).sum(1)


@torch.no_grad()
def logits(weights: dict, model: dict, tokens: torch.Tensor, prompt_len: int,
           group_len: int, weight_fmt: str = "f32") -> torch.Tensor:
    """Logits (T - prompt_len + 1, vocab) at positions prompt_len - 1 ..
    T - 1 of the token sequence ``tokens`` (T,), the prompt followed by
    the served tokens but the last."""
    fmt = weight_fmt
    eps, theta = model["norm_eps"], model["rope_theta"]
    h, kvh, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    emb = weights["embed"]
    x = emb[tokens].float()
    t = x.shape[0]
    layers = weights["pos0"]
    for li in range(model["n_layers"]):
        a = layers["attn"]
        hn = rmsnorm(x, layers["norm_mixer"][li], eps)
        q = _mm(hn, a["wq"][li], fmt).reshape(t, h, hd).transpose(0, 1)
        k = _mm(hn, a["wk"][li], fmt).reshape(t, kvh, hd).transpose(0, 1)
        v = _mm(hn, a["wv"][li], fmt).reshape(t, kvh, hd).transpose(0, 1)
        o = attention(rope(q, theta), rope(k, theta), v)
        x = x + _mm(o.transpose(0, 1).reshape(t, h * hd), a["wo"][li], fmt)
        hn = rmsnorm(x, layers["norm_mlp"][li], eps)
        if model.get("moe"):
            p = {name: w[li] for name, w in layers["moe"].items()}
            x = x + moe(hn, p, model, prompt_len, group_len, fmt)
        else:
            p = layers["mlp"]
            g = torch.nn.functional.silu(_mm(hn, p["w_gate"][li], fmt))
            x = x + _mm(g * _mm(hn, p["w_in"][li], fmt), p["w_out"][li], fmt)
    x = rmsnorm(x[prompt_len - 1:], weights["final_norm"], eps)
    return _mm(x, emb[:model["vocab"]].T, fmt)
