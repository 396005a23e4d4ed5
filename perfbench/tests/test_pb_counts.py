"""The frozen roofline and MFU counts against hand-computed shapes."""
import json
import os

import pytest

from kit import counts

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(name):
    with open(os.path.join(PB, "configs", name + ".json")) as f:
        return json.load(f)["model"]


def test_gemm_bound():
    # M = 128, N = K = 768: 2 * 128 * 768 * 768 = 150,994,944 FLOPs;
    # bytes 2 * (128*768 + 768*768 + 128*768) = 1,572,864.
    flops, nbytes = 150_994_944, 1_572_864
    assert counts.gemm_flops(128, 768, 768) == flops
    assert counts.gemm_bound_s(128, 768, 768) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    # Large and square: compute bound.  4096^3 * 2 / 989e12 s.
    assert counts.gemm_bound_s(4096, 4096, 4096) == pytest.approx(
        2 * 4096 ** 3 / 989e12)


def test_decode_attention_bound_is_bytes_of_true_keys():
    m = _model("phi4-mini-3.8b")  # 24 q heads, 8 kv heads of 128
    kv = [100, 4096, 1]
    keys = sum(kv)
    nbytes = 2 * (2 * 8 * 128 * keys + 2 * 24 * 128 * 3)
    assert counts.decode_attn_bound_s(m, kv) == pytest.approx(
        nbytes / 3.35e12)


def test_prefill_attention_bound():
    m = _model("granite-moe-1b-a400m")  # 16 q heads, 8 kv, head 64
    s = 2048
    flops = 4 * 16 * 64 * s * (s + 1) / 2
    nbytes = 2 * s * 64 * (2 * 16 + 2 * 8)
    assert counts.prefill_attn_bound_s(m, s) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))


def test_params_per_token():
    g = _model("granite-moe-1b-a400m")
    # attention 1024*64*(2*16 + 2*8) + experts 8*3*1024*512 + router
    # 1024*32, times 24 layers.
    per_layer = 1024 * 64 * 48 + 8 * 3 * 1024 * 512 + 1024 * 32
    assert counts.matmul_params_per_token(g) == 24 * per_layer
    p = _model("phi4-mini-3.8b")
    per_layer = 3072 * 128 * (48 + 16) + 3 * 3072 * 8192
    assert counts.matmul_params_per_token(p) == 32 * per_layer
    # phi4-mini: 3.2e9 in the layers, 0.61e9 in the tied head.
    assert 3.1e9 < counts.matmul_params_per_token(p) < 3.3e9


def test_mfu_flops():
    p = _model("phi4-mini-3.8b")
    w = counts.matmul_params_per_token(p)
    head = 2 * 3072 * 200064
    attn = 32 * 4 * 24 * 128
    assert counts.token_flops(p, 10, head=True) == pytest.approx(
        2 * w + attn * 10 + head)
    assert counts.prefill_flops(p, 3) == pytest.approx(
        3 * 2 * w + attn * 6 + head)
    assert counts.decode_flops(p, [1, 10]) == pytest.approx(
        2 * (2 * w + head) + attn * 11)
