"""The port's MoE layer, model and server held against the JAX package.

Mirrors tests/test_moe_grouped.py on the port's side, then holds it against
``repro``: the same numpy-seeded weights and inputs go through
``repro.models.layers.moe_forward`` and the port's ``moe_forward``, and the
granite smoke model through both forwards and both servers (weights carried
by ``params_from_numpy``).  Routing is compared before outputs: a token
whose top-k differed would change its output by far more than rounding.

Tolerances, relative to the output scale, all at float32: 1e-5 for a layer
and for logits (aten and XLA:CPU sum in different orders); 1e-6 between
the port's sorted dispatch and its naive loop (aten picks a matrix-vector
kernel for one row and a matrix kernel for a slab).  ``dropped_frac``
compares exactly: it counts assignments.  Greedy tokens are identical.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs.granite_moe_1b import CONFIG as REF_CONFIG  # noqa: E402
from repro.configs.granite_moe_1b import SMOKE as REF_SMOKE  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.serve import Request as RefRequest  # noqa: E402
from repro.launch.serve import VortexServer as RefServer  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.params import init_params as ref_init  # noqa: E402
from repro.models.partitioning import AxisRules, make_rules  # noqa: E402

from repro_torch.configs.granite_moe_1b import CONFIG, SMOKE  # noqa: E402
from repro_torch.launch.serve import Request, VortexServer  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import forward  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params,
    params_from_numpy,
)
from repro_torch.vortex import Engine  # noqa: E402

RULES = AxisRules(rules={}, mesh_axes=())
TOL = 1e-5
CFG = dataclasses.replace(SMOKE, dtype="float32")
REF_CFG = dataclasses.replace(REF_SMOKE, dtype="float32")


def _engine():
    return Engine(hardware="tpu_v5e", device="cpu")


def _with_capacity(cfg, capacity_factor):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    )


def _narrow(cfg):
    """granite-moe-1b's expert layout (32 experts, top-8) at d_model 128
    and d_ff_expert 64: the shape of test_moe_grouped.py's granite case."""
    return dataclasses.replace(
        cfg, d_model=128, moe=dataclasses.replace(cfg.moe, d_ff_expert=64),
    )


def _moe_params(cfg, seed, scale=0.05):
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_ff_expert
    rng = np.random.default_rng(seed)
    return {
        name: (rng.standard_normal(shape) * scale).astype(np.float32)
        for name, shape in (("router", (d, E)), ("w_in", (E, d, f)),
                            ("w_gate", (E, d, f)), ("w_out", (E, f, d)))
    }


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _scale_close(out, ref, tol, where):
    o = np.asarray(out, np.float32)
    r = np.asarray(ref, np.float32)
    assert o.shape == r.shape, where
    err = float(np.abs(o - r).max())
    assert err <= tol * max(float(np.abs(r).max()), 1.0), (where, err)


def _naive_moe(p, x, cfg):
    """Loop-over-experts reference in the port: each expert admits its
    first C assignments in flat (token, choice) order and every dropped
    assignment contributes 0.  Returns (y, dropped_frac)."""
    m = cfg.moe
    b, s, d = x.shape
    E, k = m.num_experts, m.top_k
    C = max(1, int(math.ceil(s * k * m.capacity_factor / E)))
    _, topw, topi = layers.route(p, x, cfg)
    y = torch.zeros(b, s, d)
    dropped = 0
    for g in range(b):
        admitted = [0] * E
        for t in range(s):
            for j in range(k):
                e = int(topi[g, t, j])
                if admitted[e] >= C:
                    dropped += 1
                    continue
                admitted[e] += 1
                row = x[g, t][None]
                h = layers._glu_act(cfg, row @ p["w_in"][e], row @ p["w_gate"][e])
                y[g, t] += topw[g, t, j] * (h @ p["w_out"][e])[0]
    return y, dropped / (b * s * k)


@pytest.mark.parametrize("shape", [(1, 16), (2, 33)])
def test_sort_dispatch_matches_naive_loop_no_drops(shape):
    b, s = shape
    cfg = _with_capacity(CFG, float(CFG.moe.num_experts))
    p = _torch(_moe_params(cfg, seed=1))
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((b, s, cfg.d_model))
        .astype(np.float32))
    y, _, dropped, _ = layers.moe_forward(p, x, cfg)
    y_ref, dropped_ref = _naive_moe(p, x, cfg)
    assert float(dropped) == 0.0 and dropped_ref == 0.0
    _scale_close(y.numpy(), y_ref.numpy(), 1e-6, "no drops")


def test_capacity_drops_are_fifo_and_dropped_frac_is_exact():
    cfg = _with_capacity(CFG, 0.25)
    p = _torch(_moe_params(cfg, seed=3))
    x = torch.from_numpy(
        np.random.default_rng(4).standard_normal((2, 32, cfg.d_model))
        .astype(np.float32))
    y, _, dropped, _ = layers.moe_forward(p, x, cfg)
    y_ref, dropped_ref = _naive_moe(p, x, cfg)
    assert dropped_ref > 0.0, "the case must exercise the capacity bound"
    assert float(dropped) == pytest.approx(dropped_ref, abs=1e-6)
    _scale_close(y.numpy(), y_ref.numpy(), 1e-6, "fifo drops")


@pytest.mark.parametrize("cfg", [CFG, _narrow(CONFIG)],
                         ids=["smoke", "granite_narrow"])
def test_engine_serves_three_grouped_launches_per_layer_call(cfg):
    cfg = dataclasses.replace(cfg, dtype="float32")
    p = _torch(_moe_params(cfg, seed=5))
    x = torch.from_numpy(
        np.random.default_rng(6).standard_normal((2, 33, cfg.d_model))
        .astype(np.float32))
    y_inline, aux0, drop0, topi0 = layers.moe_forward(p, x, cfg)
    eng = _engine()
    with eng.use():
        y_eng, aux1, drop1, topi1 = layers.moe_forward(p, x, cfg)
        y_eng2, _, _, _ = layers.moe_forward(p, x, cfg)
    d = eng.stats()["grouped_gemm"]
    assert d["launches"] == 6  # 2 calls x 3 projections, all experts each
    assert d["padded_calls"] == 0
    assert torch.equal(topi1, topi0)
    assert torch.equal(drop1, drop0) and torch.equal(aux1, aux0)
    _scale_close(y_eng.numpy(), y_inline.numpy(), TOL, "engine vs inline")
    assert torch.equal(y_eng2, y_eng)


def test_inline_path_unchanged_without_a_session():
    p = _torch(_moe_params(CFG, seed=7))
    x = torch.from_numpy(
        np.random.default_rng(8).standard_normal((1, 16, CFG.d_model))
        .astype(np.float32))
    eng = _engine()
    with eng.use():
        y_eng, _, _, _ = layers.moe_forward(p, x, CFG)
    before = eng.stats()["grouped_gemm"]["launches"]
    y1, _, _, _ = layers.moe_forward(p, x, CFG)
    y2, _, _, _ = layers.moe_forward(p, x, CFG)
    assert eng.stats()["grouped_gemm"]["launches"] == before == 3
    assert torch.equal(y1, y2)
    _scale_close(y1.numpy(), y_eng.numpy(), TOL, "inline after session")


@pytest.mark.parametrize("served", [False, True], ids=["inline", "engine"])
@pytest.mark.parametrize(
    "cfgs", [(CFG, REF_CFG), (_narrow(CONFIG), _narrow(REF_CONFIG))],
    ids=["smoke", "granite_narrow"],
)
def test_moe_forward_matches_reference(cfgs, served):
    cfg, ref_cfg = (dataclasses.replace(c, dtype="float32") for c in cfgs)
    pn = _moe_params(cfg, seed=9)
    x = np.random.default_rng(10).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    # Routing first: identical expert choices, or the outputs cannot agree.
    probs = jax.nn.softmax(
        jnp.einsum("gtd,de->gte", jnp.asarray(x), jnp.asarray(pn["router"])),
        -1)
    _, ref_topi = jax.lax.top_k(probs, cfg.moe.top_k)
    r_y, r_aux, r_drop = ref_layers.moe_forward(
        {k: jnp.asarray(v) for k, v in pn.items()}, jnp.asarray(x), ref_cfg,
        RULES)
    with _engine().use() if served else _nullctx():
        y, aux, drop, topi = layers.moe_forward(
            _torch(pn), torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ref_topi))
    assert float(drop) == float(r_drop)
    _scale_close(y.numpy(), np.asarray(r_y), TOL, "moe y")
    assert float(aux) == pytest.approx(float(r_aux), rel=1e-5)


class _nullctx:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------------------------
# The granite smoke model and server
# ---------------------------------------------------------------------------


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


def test_params_from_numpy_carries_the_moe_subtree(params, ref_params):
    moe, ref_moe = params["pos0"]["moe"], ref_params["pos0"]["moe"]
    assert set(moe) == set(ref_moe) == {"router", "w_in", "w_gate", "w_out"}
    assert moe["router"].dtype == torch.float32
    for name in moe:
        np.testing.assert_array_equal(moe[name].numpy(),
                                      np.asarray(ref_moe[name]))
    assert moe["w_in"].shape == (CFG.n_groups, 4, 64, 64)


def test_seeded_expert_init_takes_the_input_width_as_fan_in():
    # The reference draws expert stacks with the expert count as fan-in
    # (std E^-1/2); the port with each expert's input width (ROADMAP C2).
    cfg = dataclasses.replace(_narrow(CONFIG), n_layers=1, vocab=256)
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    moe = init_params(cfg, torch.Generator().manual_seed(0), "cpu")[
        "pos0"]["moe"]
    for name, fan_in in (("w_in", d), ("w_gate", d), ("w_out", f)):
        std = moe[name].float().std().item()
        assert std == pytest.approx(fan_in ** -0.5, rel=0.05), name
    ref = ref_init(dataclasses.replace(_narrow(REF_CONFIG), n_layers=1,
                                       vocab=256), jax.random.PRNGKey(0))
    ref_std = float(np.asarray(ref["pos0"]["moe"]["w_in"], np.float32).std())
    assert ref_std == pytest.approx(E ** -0.5, rel=0.05)


@pytest.mark.parametrize("served", [False, True], ids=["inline", "engine"])
def test_logits_match_reference_forward(params, ref_params, rules, served):
    rng = np.random.default_rng(11)
    b, s, cache_len = 2, 13, 16
    toks = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    r_logits, r_cache, _, r_stats = ref_model.forward(
        REF_CFG, rules, ref_params, jnp.asarray(toks), mode="prefill",
        cache_len=cache_len, return_moe_stats=True,
    )
    eng = _engine()
    with eng.use() if served else _nullctx():
        logits, cache, stats = forward(
            CFG, params, torch.from_numpy(toks).long(), mode="prefill",
            cache_len=cache_len, return_moe_stats=True,
        )
    _scale_close(logits.numpy(), np.asarray(r_logits), TOL, "prefill logits")
    assert float(stats["dropped_frac"]) == pytest.approx(
        float(r_stats["dropped_frac"]), abs=1e-7)
    assert len(stats["topi"]) == CFG.n_layers
    nxt = rng.integers(0, CFG.vocab, (b, 1)).astype(np.int32)
    r_logits, _, _ = ref_model.forward(
        REF_CFG, rules, ref_params, jnp.asarray(nxt), mode="decode",
        cache=r_cache, pos=jnp.asarray(s, jnp.int32), cache_len=cache_len,
    )
    with eng.use() if served else _nullctx():
        logits, _ = forward(
            CFG, params, torch.from_numpy(nxt).long(), mode="decode",
            cache=cache, pos=s,
        )
    _scale_close(logits.numpy(), np.asarray(r_logits), TOL, "decode logits")
    if served:
        d = eng.stats()["grouped_gemm"]
        assert d["launches"] == 2 * 3 * CFG.n_layers  # prefill + decode
        assert d["padded_calls"] == 0


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
    rng = np.random.default_rng(12)
    for s in (16, 32):
        assert port.seq_bucket(s) == s
        toks = rng.integers(0, CFG.vocab, (3, s)).astype(np.int32)
        want = ref.generate(RefRequest(tokens=toks, max_new=5))
        got = port.generate(Request(tokens=toks, max_new=5))
        np.testing.assert_array_equal(got, want)


def test_first_token_matches_reference_on_the_same_padded_batch(
    servers, ref_params, rules,
):
    # Capacity follows the PADDED length, so the reference is the JAX
    # forward over the same (batch-bucket, seq-bucket) batch, read at s-1.
    _, port = servers
    rng = np.random.default_rng(13)
    for b, s in ((2, 5), (3, 21)):
        assert port.seq_bucket(s) > s  # an unaligned prompt
        toks = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
        padded = np.zeros((port.batch_bucket(b), port.seq_bucket(s)), np.int32)
        padded[:b, :s] = toks
        r_logits, _, _ = ref_model.forward(
            REF_CFG, rules, ref_params, jnp.asarray(padded), mode="train")
        want = np.asarray(jnp.argmax(r_logits[:b, s - 1], -1))
        got = port.generate(Request(tokens=toks, max_new=1))
        np.testing.assert_array_equal(got[:, 0], want)


def test_server_counts_grouped_launches_and_drops(params):
    port = VortexServer(
        CFG, max_cache=128, params=params, device="cpu", hardware="tpu_v5e",
    )
    built = port.warmup(max_batch=4, m_max=64, max_new=6)
    grouped = [k for k in port.engine._kernels.values()
               if k.workload.kind == "grouped_gemm"]
    # One signature per (N, K) projection shape and batch bucket 1, 2, 4
    # (the smoke config's d_ff_expert == d_model: one shape).
    shapes = {(CFG.moe.d_ff_expert, CFG.d_model),
              (CFG.d_model, CFG.moe.d_ff_expert)}
    assert len(grouped) == len(shapes) * 3
    entries = sum(k.cache_info["entries"] for k in grouped)
    assert 0 < entries <= built
    rng = np.random.default_rng(14)
    for b, s in ((3, 9), (1, 40)):
        port.generate(Request(
            tokens=rng.integers(0, CFG.vocab, (b, s)).astype(np.int32),
            max_new=6))
    # Warmup reached every capacity bucket the requests needed.
    assert sum(k.cache_info["entries"] for k in grouped) == entries
    st = port.engine_dispatch_stats()
    forwards = 2 * 6  # one prefill + 5 decode steps per request
    assert st["grouped_gemm"]["launches"] == 3 * CFG.n_layers * forwards
    assert st["grouped_gemm"]["padded_calls"] == 0
    assert st["kv_pool"]["leases_active"] == 0
    assert 0.0 <= port.mean_dropped_frac() < 1.0
