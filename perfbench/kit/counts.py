"""The yardstick's arithmetic: the chip's peaks, and the operations and
bytes that the inputs need, counted from shapes and from the
configuration file, never from what the program dispatched.

Peaks: NVIDIA's H100 SXM data sheet, dense bf16 989 TFLOP/s, HBM3 3.35
TB/s, at the full 700 W limit.  A roofline bound is the larger of
operations over the compute peak and bytes over the bandwidth peak, each
input byte read once and each output byte written once.
"""
from __future__ import annotations

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
