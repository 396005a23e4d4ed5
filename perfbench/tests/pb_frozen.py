"""Frozen copies of the harness's weight drawing, counts and decoder
reference as they stood before configuration files could state a layer
pattern.  A file without ``pattern`` must draw, count and judge exactly
as these do (``test_pb_layers.py``).  Never edit this file to follow a
change: a change that moves these numbers moves the existing cells."""
from __future__ import annotations

import math

import torch


# -- kit/weights.py --------------------------------------------------------

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaves(model: dict) -> list[tuple[str, tuple, str, int | None]]:
    """(path, shape, dtype, fan-in or None for a norm of ones), in the
    order they are drawn."""
    L, d = model["n_layers"], model["d_model"]
    h, kv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    dt = model["dtype"]
    out = [
        ("embed", (model["vocab_padded"], d), dt, d),
        ("final_norm", (d,), dt, None),
        ("pos0/norm_mixer", (L, d), dt, None),
        ("pos0/norm_mlp", (L, d), dt, None),
        ("pos0/attn/wq", (L, d, h * hd), dt, d),
        ("pos0/attn/wk", (L, d, kv * hd), dt, d),
        ("pos0/attn/wv", (L, d, kv * hd), dt, d),
        ("pos0/attn/wo", (L, h * hd, d), dt, h * hd),
    ]
    moe = model.get("moe")
    if moe:
        e, fe = moe["num_experts"], moe["d_ff_expert"]
        out += [
            ("pos0/moe/router", (L, d, e), "float32", d),
            ("pos0/moe/w_in", (L, e, d, fe), dt, d),
            ("pos0/moe/w_gate", (L, e, d, fe), dt, d),
            ("pos0/moe/w_out", (L, e, fe, d), dt, fe),
        ]
    else:
        f = model["d_ff"]
        out += [
            ("pos0/mlp/w_in", (L, d, f), dt, d),
            ("pos0/mlp/w_gate", (L, d, f), dt, d),
            ("pos0/mlp/w_out", (L, f, d), dt, f),
        ]
    return out


def draw(model: dict, seed: int, device) -> dict:
    """The nested weight tree for ``model`` from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    tree: dict = {}
    for path, shape, dt, fan_in in leaves(model):
        dtype = _DTYPES[dt]
        if fan_in is None:
            t = torch.ones(shape, dtype=dtype, device=device)
        else:
            t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
            t.mul_(1.0 / math.sqrt(fan_in))
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


def nbytes(model: dict) -> int:
    """Bytes of the served weights."""
    size = {"bfloat16": 2, "float32": 4}
    return sum(math.prod(shape) * size[dt]
               for _, shape, dt, _ in leaves(model))


# -- kit/counts.py ---------------------------------------------------------

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
PEAK_BYTES = 3.35e12  # HBM3
BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take for this work."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def gemm_flops(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


def gemm_bound_s(m: int, n: int, k: int, elt: int = BF16) -> float:
    """(M, K) @ (K, N) -> (M, N), each operand once."""
    return bound_s(gemm_flops(m, n, k), elt * (m * k + k * n + m * n))


def decode_attn_bound_s(model: dict, kv_lens, elt: int = BF16) -> float:
    """One layer's decode attention over rows whose key counts are
    ``kv_lens``: K and V of each row's keys once, plus q and out."""
    h, kv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    keys = float(sum(kv_lens))
    rows = len(kv_lens)
    nbytes = elt * (2 * kv * hd * keys + 2 * h * hd * rows)
    flops = 4.0 * h * hd * keys
    return bound_s(flops, nbytes)


def causal_pairs(s: int) -> float:
    """(query, key) pairs under a causal mask over s tokens."""
    return s * (s + 1) / 2.0


def prefill_attn_bound_s(model: dict, s: int, elt: int = BF16) -> float:
    """One layer's causal prefill attention over a prompt of ``s`` true
    tokens: q, k, v and out once, QK^T and PV over the causal pairs."""
    h, kv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    nbytes = elt * s * hd * (2 * h + 2 * kv)
    flops = 4.0 * h * hd * causal_pairs(s)
    return bound_s(flops, nbytes)


def matmul_params_per_token(model: dict) -> float:
    """Weights one token multiplies by in the layers (attention
    projections and the MLP, or the routed top-k experts and the router),
    over all layers; the LM head apart."""
    d, h, kv, hd = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                    model["head_dim"])
    attn = d * hd * (2 * h + 2 * kv)
    moe = model.get("moe")
    if moe:
        mlp = moe["top_k"] * 3 * d * moe["d_ff_expert"] + d * moe[
            "num_experts"]
    else:
        mlp = 3 * d * model["d_ff"]
    return float(model["n_layers"] * (attn + mlp))


def token_flops(model: dict, kv_len: int, head: bool) -> float:
    """Model FLOPs of one token: every weight it multiplies by (2 per
    weight), attention over its ``kv_len`` keys in every layer, and the
    LM head over the true vocabulary when its logits are needed."""
    f = 2.0 * matmul_params_per_token(model)
    f += model["n_layers"] * 4.0 * model["n_heads"] * model["head_dim"] * kv_len
    if head:
        f += 2.0 * model["d_model"] * model["vocab"]
    return f


def prefill_flops(model: dict, s: int) -> float:
    """A prompt of ``s`` true tokens: each token over its causal keys, the
    head only at the last one (the first output token's logits)."""
    f = s * 2.0 * matmul_params_per_token(model)
    f += model["n_layers"] * 4.0 * model["n_heads"] * model["head_dim"] * \
        causal_pairs(s)
    f += 2.0 * model["d_model"] * model["vocab"]
    return f


def decode_flops(model: dict, kv_lens) -> float:
    """One decode step of rows whose key counts are ``kv_lens``."""
    return sum(token_flops(model, int(n), head=True) for n in kv_lens)


# -- reference/decoder.py --------------------------------------------------

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
