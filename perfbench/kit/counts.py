"""The yardstick's arithmetic: the chip's peaks, and the operations and
bytes that the inputs need, counted from shapes and from the
configuration file, never from what the program dispatched.

A model's counts follow its layer pattern (``kit/layout.py``):
attention terms come from its ``attn`` layers, latent attention's from
its ``mla`` layers (the naive form a prefill runs, the absorbed form a
decode runs), and a Mamba layer's projections and scan from its
``mamba`` layers.

Peaks: NVIDIA's H100 SXM data sheet, dense bf16 989 TFLOP/s, HBM3 3.35
TB/s, at the full 700 W limit.  A roofline bound is the larger of
operations over the compute peak and bytes over the bandwidth peak, each
input byte read once and each output byte written once.
"""
from __future__ import annotations

from kit import layout

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


def _layer_share(model: dict, bound: float) -> float:
    """One attention layer's ``bound`` spread over the model's layers: the
    attention layers' total over ``n_layers``, so that ``n_layers`` times
    it (what the roofline readers take) is the model's whole attention.
    With attention in every layer, ``bound`` itself."""
    n, total = layout.layers_of(model, "attn"), model["n_layers"]
    return bound if n == total else bound * n / total


def decode_attn_bound_s(model: dict, kv_lens, elt: int = BF16) -> float:
    """Decode attention over rows whose key counts are ``kv_lens``, per
    layer of the model (:func:`_layer_share`): in one attention layer, K
    and V of each row's keys once, plus q and out."""
    h, kv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    keys = float(sum(kv_lens))
    rows = len(kv_lens)
    nbytes = elt * (2 * kv * hd * keys + 2 * h * hd * rows)
    flops = 4.0 * h * hd * keys
    return _layer_share(model, bound_s(flops, nbytes))


def causal_pairs(s: int) -> float:
    """(query, key) pairs under a causal mask over s tokens."""
    return s * (s + 1) / 2.0


def prefill_attn_bound_s(model: dict, s: int, elt: int = BF16) -> float:
    """Causal prefill attention over a prompt of ``s`` true tokens, per
    layer of the model (:func:`_layer_share`): in one attention layer, q,
    k, v and out once, QK^T and PV over the causal pairs."""
    h, kv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    nbytes = elt * s * hd * (2 * h + 2 * kv)
    flops = 4.0 * h * hd * causal_pairs(s)
    return _layer_share(model, bound_s(flops, nbytes))


def _mixer_params(model: dict, mixer: str) -> int:
    d = model["d_model"]
    if mixer == "attn":
        h, kv, hd = model["n_heads"], model["n_kv_heads"], \
            model["head_dim"]
        return d * hd * (2 * h + 2 * kv)
    if mixer == "mamba":
        s = model["ssm"]
        di, dtr = s["d_inner"], s["dt_rank"]
        # in_proj, x_proj, dt_proj, out_proj.
        return d * 2 * di + di * (dtr + 2 * s["d_state"]) + dtr * di + \
            di * d
    m, h = model["mla"], model["n_heads"]
    c, rope = m["kv_lora_rank"], m["qk_rope_dim"]
    # wdq, wuq, wdkv, wuk, wuv, wo: the naive prefill and the absorbed
    # decode multiply by each once a token.
    return (d * m["q_lora_rank"]
            + m["q_lora_rank"] * h * (m["qk_nope_dim"] + rope)
            + d * (c + rope) + c * h * m["qk_nope_dim"]
            + c * h * m["v_head_dim"] + h * m["v_head_dim"] * d)


def _mlp_params(model: dict, mlp: str) -> int:
    d = model["d_model"]
    if mlp == "dense":
        return 3 * d * model["d_ff"]
    if mlp == "none":
        return 0
    moe = model["moe"]
    out = moe["top_k"] * 3 * d * moe["d_ff_expert"] + d * moe["num_experts"]
    shared = layout.num_shared(model)
    if shared:
        out += shared * 3 * d * moe["d_ff_expert"]
    return out


def matmul_params_per_token(model: dict) -> float:
    """Weights one token multiplies by in the layers (each mixer's
    projections, and the MLP, or the routed top-k experts, the shared
    experts and the router), over all layers; the LM head apart."""
    period = sum(_mixer_params(model, p["mixer"]) +
                 _mlp_params(model, p["mlp"]) for p in layout.pattern(model))
    return float(layout.n_groups(model) * period)


def mamba_token_flops(model: dict) -> float:
    """One token's elementwise work in one Mamba layer, its projections
    apart: the causal depthwise conv, 2 * d_conv a channel (a multiply
    and an add a tap); per channel Delta * x, D * x, its add and the
    gate's multiply, 4; and per channel and state 7: Delta * A, its exp,
    (Delta * x) * B, the decay's multiply and the add of the recurrence,
    C * h and the sum over states.  Softplus and SiLU are not counted,
    as no activation is elsewhere."""
    s = model["ssm"]
    return float(s["d_inner"] * (2 * s["d_conv"] + 4 + 7 * s["d_state"]))


def mla_key_flops(model: dict) -> float:
    """One decode token's latent attention per key in one MLA layer, the
    absorbed form: scores over the latent and the rotary part, 2 * H *
    (kv_lora_rank + qk_rope_dim), and the latent values, 2 * H *
    kv_lora_rank."""
    m, h = model["mla"], model["n_heads"]
    return 2.0 * h * (2 * m["kv_lora_rank"] + m["qk_rope_dim"])


def mla_pair_flops(model: dict) -> float:
    """A prefill's latent attention per causal (query, key) pair in one
    MLA layer, the naive form: QK^T over qk_nope_dim + qk_rope_dim and PV
    over v_head_dim, each a multiply and an add a head."""
    m, h = model["mla"], model["n_heads"]
    return 2.0 * h * (m["qk_nope_dim"] + m["qk_rope_dim"] + m["v_head_dim"])


def token_flops(model: dict, kv_len: int, head: bool) -> float:
    """Model FLOPs of one decode token: every weight it multiplies by (2
    per weight), attention over its ``kv_len`` keys in every attention
    and MLA layer, each Mamba layer's scan, and the LM head over the true
    vocabulary when its logits are needed."""
    f = 2.0 * matmul_params_per_token(model)
    f += layout.layers_of(model, "attn") * 4.0 * model["n_heads"] * \
        model["head_dim"] * kv_len
    n_mla, n_mamba = (layout.layers_of(model, k) for k in ("mla", "mamba"))
    if n_mla:
        f += n_mla * mla_key_flops(model) * kv_len
    if n_mamba:
        f += n_mamba * mamba_token_flops(model)
    if head:
        f += 2.0 * model["d_model"] * model["vocab"]
    return f


def prefill_flops(model: dict, s: int) -> float:
    """A prompt of ``s`` true tokens: each token over its causal keys in
    every attention and MLA layer and through each Mamba layer's scan,
    the head only at the last one (the first output token's logits)."""
    f = s * 2.0 * matmul_params_per_token(model)
    f += layout.layers_of(model, "attn") * 4.0 * model["n_heads"] * \
        model["head_dim"] * causal_pairs(s)
    n_mla, n_mamba = (layout.layers_of(model, k) for k in ("mla", "mamba"))
    if n_mla:
        f += n_mla * mla_pair_flops(model) * causal_pairs(s)
    if n_mamba:
        f += n_mamba * s * mamba_token_flops(model)
    f += 2.0 * model["d_model"] * model["vocab"]
    return f


def decode_flops(model: dict, kv_lens) -> float:
    """One decode step of rows whose key counts are ``kv_lens``."""
    return sum(token_flops(model, int(n), head=True) for n in kv_lens)
