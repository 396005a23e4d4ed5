"""The port's model and server held against the JAX package.

Weights cross from the reference's ``init_params`` through numpy
(``params_from_numpy``), so both sides compute the same function.  At f32
on the smoke config: prefill and decode logits agree within 1e-4 of the
logit scale (aten and XLA:CPU sum in different orders over 2 layers), and
greedy tokens are identical.  At prompt lengths that are not a sequence
bucket the reference server reads its first token at a pad position
(serve.py:859-864 with step.py:150); the port reads row s-1, which the
unpadded reference forward confirms.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs.paper_gpt2 import SMOKE as REF_SMOKE  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.serve import Request as RefRequest  # noqa: E402
from repro.launch.serve import VortexServer as RefServer  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.params import init_params as ref_init  # noqa: E402
from repro.models.partitioning import make_rules  # noqa: E402

from repro_torch.configs.paper_gpt2 import SMOKE  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    CacheOverflowError,
    KVBucketPool,
    Request,
    VortexServer,
)
from repro_torch.models.model import forward, make_cache  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params,
    params_from_numpy,
)
from repro_torch.vortex import Engine  # noqa: E402

CFG = dataclasses.replace(SMOKE, dtype="float32")
REF_CFG = dataclasses.replace(REF_SMOKE, dtype="float32")
TOL = 1e-4


@pytest.fixture(scope="module")
def ref_params():
    return ref_init(REF_CFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(ref_params):
    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    return params_from_numpy(CFG, tree, "cpu")


@pytest.fixture(scope="module")
def rules():
    return make_rules(
        make_host_mesh(), n_heads=REF_CFG.n_heads, n_kv_heads=REF_CFG.n_kv_heads
    )


def _close(out, ref, where):
    r = np.asarray(ref, np.float32)
    o = out.detach().float().numpy()
    assert o.shape == r.shape, where
    err = float(np.abs(o - r).max())
    assert err <= TOL * max(float(np.abs(r).max()), 1.0), (where, err)


def _ref_greedy(ref_params, rules, tokens, n):
    """Greedy continuation by the UNPADDED reference forward."""
    seq = np.asarray(tokens)
    out = []
    for _ in range(n):
        logits, _, _ = ref_model.forward(
            REF_CFG, rules, ref_params, jnp.asarray(seq), mode="train",
        )
        nxt = np.asarray(jnp.argmax(logits[:, -1], -1))
        out.append(nxt)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
    return np.stack(out, 1)


def test_params_from_numpy_carries_every_leaf(params, ref_params):
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_params)
    assert len(ref_leaves) == len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: 0, params)))
    np.testing.assert_array_equal(
        params["pos0"]["attn"]["wq"].numpy(),
        np.asarray(ref_params["pos0"]["attn"]["wq"]),
    )
    assert params["pos0"]["attn"]["wq"].shape[0] == CFG.n_groups


@pytest.mark.parametrize("served", [False, True], ids=["inline", "engine"])
def test_prefill_and_decode_logits_match_reference(params, ref_params, rules,
                                                   served):
    rng = np.random.default_rng(0)
    b, s, cache_len = 2, 11, 16
    toks = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    r_logits, r_cache, _ = ref_model.forward(
        REF_CFG, rules, ref_params, jnp.asarray(toks), mode="prefill",
        cache_len=cache_len,
    )
    eng = Engine(hardware="tpu_v5e", device="cpu")
    with eng.use() if served else _nullctx():
        logits, cache = forward(
            CFG, params, torch.from_numpy(toks).long(), mode="prefill",
            cache_len=cache_len,
        )
    _close(logits, r_logits, "prefill logits")
    _close(cache["pos0"]["k"], r_cache["pos0"]["k"], "prefill k cache")
    nxt = rng.integers(0, CFG.vocab, (b, 1)).astype(np.int32)
    r_logits, _, _ = ref_model.forward(
        REF_CFG, rules, ref_params, jnp.asarray(nxt), mode="decode",
        cache=r_cache, pos=jnp.asarray(s, jnp.int32), cache_len=cache_len,
    )
    with eng.use() if served else _nullctx():
        logits, cache = forward(
            CFG, params, torch.from_numpy(nxt).long(), mode="decode",
            cache=cache, pos=s,
        )
    _close(logits, r_logits, "decode logits")
    if served:
        st = eng.stats()
        assert st["attention"]["launches"] == CFG.n_layers
        assert st["decode_attention"]["launches"] == CFG.n_layers
        assert st["decode_attention"]["padded_calls"] == 0


class _nullctx:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def servers(params):
    ref = RefServer(REF_CFG, make_host_mesh(), max_cache=64, seed=0)
    port = VortexServer(
        CFG, max_cache=64, params=params, device="cpu", hardware="tpu_v5e",
    )
    return ref, port


def test_buckets_identical_to_reference_server(servers):
    ref, port = servers
    for s in range(1, 65):
        assert port.seq_bucket(s) == ref.seq_bucket(s), s
        assert port.kv_bucket(s) == ref.kv_bucket(s), s
    assert port.decode_buckets(max_new=8) == ref.decode_buckets(max_new=8)


def test_greedy_tokens_identical_at_aligned_prompt_lengths(servers):
    ref, port = servers
    rng = np.random.default_rng(1)
    for s in (16, 32):
        assert port.seq_bucket(s) == s
        toks = rng.integers(0, CFG.vocab, (2, s)).astype(np.int32)
        want = ref.generate(RefRequest(tokens=toks, max_new=5))
        got = port.generate(Request(tokens=toks, max_new=5))
        np.testing.assert_array_equal(got, want)


def test_first_token_reads_the_last_real_position(servers, ref_params, rules):
    _, port = servers
    rng = np.random.default_rng(2)
    for s in (5, 21):
        assert port.seq_bucket(s) > s  # an unaligned prompt
        toks = rng.integers(0, CFG.vocab, (2, s)).astype(np.int32)
        got = port.generate(Request(tokens=toks, max_new=3))
        np.testing.assert_array_equal(
            got, _ref_greedy(ref_params, rules, toks, 3)
        )


def test_decode_is_one_step_and_n_layers_launches_per_token(params):
    port = VortexServer(
        CFG, max_cache=256, params=params, device="cpu", hardware="tpu_v5e",
    )
    rng = np.random.default_rng(3)
    toks = rng.integers(0, CFG.vocab, (3, 9)).astype(np.int32)
    port.generate(Request(tokens=toks, max_new=6))
    st = port.engine_dispatch_stats()
    assert st["decode_step"]["launches"] == 5
    assert st["decode_step"]["padded_calls"] == 0
    assert st["decode_attention"]["launches"] == 5 * CFG.n_layers
    assert st["decode_attention"]["stage_copies"] == 0
    assert st["decode_attention"]["padded_calls"] == 0


def test_kv_pool_lease_ledger_settles(params, monkeypatch):
    port = VortexServer(
        CFG, max_cache=256, params=params, device="cpu", hardware="tpu_v5e",
    )
    rng = np.random.default_rng(4)
    s = 120
    kvb = port.kv_bucket(port.seq_bucket(s))
    max_new = kvb - s + 4  # forces one growth into the next kv bucket
    toks = rng.integers(0, CFG.vocab, (1, s)).astype(np.int32)
    out = port.generate(Request(tokens=toks, max_new=max_new))
    assert out.shape == (1, max_new)
    pool = port.kv_pool.stats()
    assert pool["leases_active"] == 0
    assert port.decode_stats.stage_copies == 2  # one growth: the k and v leaves
    # A decode failure mid-request still settles every lease.
    calls = {"n": 0}
    real = serve.decode_step

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected decode failure")
        return real(*a, **k)

    monkeypatch.setattr(serve, "decode_step", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        port.generate(Request(tokens=toks[:, :10], max_new=6))
    assert port.kv_pool.stats()["leases_active"] == 0
    with pytest.raises(CacheOverflowError):
        port.generate(Request(tokens=toks, max_new=200))
    assert port.kv_pool.stats()["leases_active"] == 0


def test_pool_reuses_released_buffers():
    pool = KVBucketPool()
    a = pool.lease((2, 3), torch.float32, "cpu")
    pool.release(a)
    b = pool.lease((2, 3), torch.float32, "cpu")
    assert b is a
    assert pool.stats() == {
        "leases_active": 1, "leases_peak": 1, "lease_hits": 1,
        "lease_allocs": 1, "released": 1,
    }


def test_seeded_init_is_deterministic():
    p1 = init_params(CFG, torch.Generator().manual_seed(7), "cpu")
    p2 = init_params(CFG, torch.Generator().manual_seed(7), "cpu")
    assert torch.equal(p1["embed"], p2["embed"])
    assert torch.equal(p1["pos0"]["mlp"]["w_in"], p2["pos0"]["mlp"]["w_in"])


def test_make_cache_matches_reference_layout():
    cache = make_cache(CFG, 3, 48, device="cpu")
    ref = ref_model.make_cache(REF_CFG, 3, 48)
    assert cache.keys() == ref.keys()
    for key in ref:
        for name in ("k", "v"):
            assert tuple(cache[key][name].shape) == ref[key][name].shape
            assert not cache[key][name].any()
