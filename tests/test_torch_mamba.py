"""The port's Mamba layers and the falcon-mamba and jamba models and
servers held against the JAX package.

The same weights (the reference's ``init_params``, carried over by
``params_from_numpy``) and the same numpy-seeded inputs go through
``repro.models.layers.mamba_forward`` / ``_ssm_chunk_scan`` and the port's,
through both models' prefill and decode, and through both servers.  MoE
layers run at a no-drop capacity (``capacity_factor = num_experts``), as
tests/test_decode_consistency.py does: the capacity follows the padded
token count, so a drop would legitimately change the tokens.

The reference server's prefill scans the bucket pad into the Mamba state
(ROADMAP C11); the port keeps the state of the last real prompt token, so
at an unaligned prompt length its greedy tokens are the JAX package's
unpadded greedy decode, and the reference server's are not.

Tolerances, relative to the output scale, all at float32: 1e-5 for a
layer and a chunk scan (aten and XLA:CPU sum in different orders, and the
doubling scan is not ``associative_scan``'s tree); 1e-4 for logits through
a whole model.  Greedy tokens and the servers' counters are identical.
The card's graphed steps are held against eager ones in
tests/test_torch_graphs.py (no jax there).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs import falcon_mamba_7b as ref_falcon  # noqa: E402
from repro.configs import jamba_v01_52b as ref_jamba  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.serve import Request as RefRequest  # noqa: E402
from repro.launch.serve import VortexServer as RefServer  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import params as ref_params_mod  # noqa: E402
from repro.models.partitioning import AxisRules, make_rules  # noqa: E402

from repro_torch.configs import falcon_mamba_7b, jamba_v01_52b  # noqa: E402
from repro_torch.launch import graphs  # noqa: E402
from repro_torch.launch.serve import Request, VortexServer  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402
from repro_torch.models import params as params_mod  # noqa: E402

RULES = AxisRules(rules={}, mesh_axes=())
LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
MODULES = {"falcon-mamba-7b": (falcon_mamba_7b, ref_falcon),
           "jamba-v0.1-52b": (jamba_v01_52b, ref_jamba)}
ARCHS = list(MODULES)


def _f32_no_drop(cfg):
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def _close(out, ref, tol, where):
    o = np.asarray(out, np.float32)
    r = np.asarray(ref, np.float32)
    assert o.shape == r.shape, (where, o.shape, r.shape)
    err = float(np.abs(o - r).max())
    assert err <= tol * max(float(np.abs(r).max()), 1.0), (where, err)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(port cfg, ref cfg, port params, ref params, rules) for the f32
    no-drop smoke config."""
    mod, ref_mod = MODULES[arch]
    cfg, ref_cfg = _f32_no_drop(mod.SMOKE), _f32_no_drop(ref_mod.SMOKE)
    ref_p = ref_params_mod.init_params(ref_cfg, jax.random.PRNGKey(0))
    p = params_mod.params_from_numpy(cfg, _np(ref_p), "cpu")
    rules = make_rules(make_host_mesh(), n_heads=ref_cfg.n_heads,
                       n_kv_heads=ref_cfg.n_kv_heads)
    return cfg, ref_cfg, p, ref_p, rules


def _greedy_unpadded(arch, toks, max_new):
    """The JAX package's greedy decode of ``toks`` with no bucket pad:
    prefill at the exact length, then one decode step per token."""
    _, ref_cfg, _, ref_p, rules = _model(arch)
    b, s = toks.shape
    n = s + max_new
    pre = jax.jit(lambda p, t: ref_model.forward(
        ref_cfg, rules, p, t, mode="prefill", cache_len=n)[:2])
    dec = jax.jit(lambda p, c, t, pos: ref_model.forward(
        ref_cfg, rules, p, t, mode="decode", cache=c, pos=pos,
        cache_len=n)[:2])
    logits, cache = pre(ref_p, jnp.asarray(toks))
    out = [np.asarray(jnp.argmax(logits[:, -1], -1))]
    for i in range(max_new - 1):
        logits, cache = dec(ref_p, cache, jnp.asarray(out[-1][:, None]),
                            jnp.asarray(s + i, jnp.int32))
        out.append(np.asarray(jnp.argmax(logits[:, 0], -1)))
    return np.stack(out, 1)


def _leaf_defs(schema, leaves):
    return [(path, d.shape, d.dtype, d.init) for path, d in leaves(schema)]


@pytest.mark.parametrize("size", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_schema_matches_reference_leaf_for_leaf(arch, size):
    mod, ref_mod = MODULES[arch]
    got = _leaf_defs(params_mod.model_schema(getattr(mod, size)),
                     params_mod._leaves)
    want = _leaf_defs(ref_params_mod.model_schema(getattr(ref_mod, size)),
                      ref_params_mod._leaves)
    assert got == want
    mamba = [p for p, *_ in got if "/mamba/" in p]
    assert {p.rsplit("/", 1)[1] for p in mamba} == {
        "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
        "A_log", "D", "out_proj"}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch):
    mod, ref_mod = MODULES[arch]
    for size in ("CONFIG", "SMOKE"):
        got = dataclasses.asdict(getattr(mod, size))
        want = dataclasses.asdict(getattr(ref_mod, size))
        assert got == want, size


def test_constant_inits_match_reference():
    cfg = falcon_mamba_7b.SMOKE
    p = params_mod.init_params(cfg, torch.Generator().manual_seed(0),
                               "cpu")["pos0"]["mamba"]
    ref = ref_params_mod.init_params(ref_falcon.SMOKE,
                                     jax.random.PRNGKey(0))["pos0"]["mamba"]
    for name in ("D", "conv_b", "dt_bias"):
        assert p[name].dtype == {"D": torch.float32}.get(name, torch.bfloat16)
        np.testing.assert_array_equal(p[name].float().numpy(),
                                      np.asarray(ref[name], np.float32))
    # A_log = log(1..d_state) over d_inner, float32: correctly rounded in
    # the port, within one float32 ulp of XLA's log.
    want = np.log(np.arange(1, cfg.ssm.d_state + 1)).astype(np.float32)
    assert p["A_log"].dtype == torch.float32
    np.testing.assert_array_equal(
        p["A_log"].numpy(), np.broadcast_to(want, p["A_log"].shape))
    np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(ref["A_log"]),
                               rtol=2 ** -23, atol=0)


@pytest.mark.parametrize("L", [1, 2, 3, 7, 16, 33])
def test_chunk_scan_matches_associative_scan(L):
    rng = np.random.default_rng(L)
    b, di, ds = 2, 5, 3
    a = rng.uniform(0.5, 1.0, (b, L, di, ds)).astype(np.float32)
    bx = rng.standard_normal((b, L, di, ds)).astype(np.float32)
    h0 = rng.standard_normal((b, di, ds)).astype(np.float32)
    want_all, want_last = ref_layers._ssm_chunk_scan(
        jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    got_all, got_last = layers._ssm_chunk_scan(
        torch.from_numpy(a), torch.from_numpy(bx), torch.from_numpy(h0))
    _close(got_all.numpy(), want_all, LAYER_TOL, "h_all")
    _close(got_last.numpy(), want_last, LAYER_TOL, "h_last")


def _mamba_params(arch):
    _, _, p, ref_p, _ = _model(arch)
    mp = {k: v[0] for k, v in p["pos0"]["mamba"].items()}
    ref_mp = {k: v[0] for k, v in ref_p["pos0"]["mamba"].items()}
    return mp, ref_mp


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_forward_matches_reference_prefill_and_decode(arch):
    cfg, ref_cfg, _, _, _ = _model(arch)
    mp, ref_mp = _mamba_params(arch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    r_y, r_cache = ref_layers.mamba_forward(ref_mp, jnp.asarray(x), ref_cfg,
                                            RULES, mode="prefill")
    y, cache = layers.mamba_forward(mp, torch.from_numpy(x), cfg,
                                    mode="prefill")
    _close(y.numpy(), r_y, LAYER_TOL, "prefill y")
    for name in ("conv", "ssm"):
        _close(cache[name].numpy(), r_cache[name], LAYER_TOL, name)
    assert cache["ssm"].dtype == torch.float32
    xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    r_y, r_new = ref_layers.mamba_forward(
        ref_mp, jnp.asarray(xd), ref_cfg, RULES, mode="decode",
        cache=r_cache, pos=jnp.asarray(21, jnp.int32))
    state = {k: v.clone() for k, v in cache.items()}
    y, new = layers.mamba_forward(mp, torch.from_numpy(xd), cfg,
                                  mode="decode", cache=state)
    assert new is state  # updated in place
    _close(y.numpy(), r_y, LAYER_TOL, "decode y")
    for name in ("conv", "ssm"):
        _close(state[name].numpy(), r_new[name], LAYER_TOL, f"decode {name}")


def test_decode_takes_exactly_one_token():
    cfg = _model(ARCHS[0])[0]
    mp, _ = _mamba_params(ARCHS[0])
    state = model.make_cache(cfg, 2, 8, "cpu")["pos0"]
    state = {k: v[0] for k, v in state.items()}
    with pytest.raises(ValueError, match="one token per step"):
        layers.mamba_forward(mp, torch.zeros(2, 2, cfg.d_model), cfg,
                             mode="decode", cache=state)


@pytest.mark.parametrize("s", [13, 2])
def test_padded_prefill_keeps_the_last_real_rows_state(s):
    """C11 on one layer: a prefill padded to 16 rows with ``last = s - 1``
    leaves the state the JAX package's prefill of the s real rows leaves
    (the conv state zero-filled before row 0 when s < d_conv - 1)."""
    arch = ARCHS[0]
    cfg, ref_cfg, _, _, _ = _model(arch)
    mp, ref_mp = _mamba_params(arch)
    x = np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    _, want = ref_layers.mamba_forward(ref_mp, jnp.asarray(x[:, :s]),
                                       ref_cfg, RULES, mode="prefill")
    last = torch.tensor([s - 1])
    _, got = layers.mamba_forward(mp, torch.from_numpy(x), cfg,
                                  mode="prefill", last=last)
    for name in ("conv", "ssm"):
        _close(got[name].numpy(), want[name], LAYER_TOL, name)
    _, padded = ref_layers.mamba_forward(ref_mp, jnp.asarray(x), ref_cfg,
                                         RULES, mode="prefill")
    assert float(np.abs(np.asarray(padded["ssm"])
                        - np.asarray(want["ssm"])).max()) > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_the_full_forward(arch):
    """Mirrors tests/test_decode_consistency.py: prefill 32 tokens, decode
    3 more one at a time, each step's logits against the JAX full
    forward's at that position."""
    cfg, ref_cfg, p, ref_p, rules = _model(arch)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 35)).astype(np.int32)
    full, _, _ = ref_model.forward(ref_cfg, rules, ref_p, jnp.asarray(toks),
                                   mode="train")
    full = np.asarray(full)
    t = torch.from_numpy(toks).long()
    logits, cache = model.forward(cfg, p, t[:, :32], mode="prefill",
                                  cache_len=40)
    _close(logits.numpy(), full[:, :32], LOGIT_TOL, "prefill")
    for pos in range(32, 35):
        logits, cache = model.forward(cfg, p, t[:, pos:pos + 1],
                                      mode="decode", cache=cache, pos=pos)
        _close(logits[:, 0].numpy(), full[:, pos], LOGIT_TOL, f"pos {pos}")


def test_jamba_decode_with_per_row_positions_matches_reference():
    arch = ARCHS[1]
    cfg, ref_cfg, p, ref_p, rules = _model(arch)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32)
    _, r_cache, _ = ref_model.forward(ref_cfg, rules, ref_p,
                                      jnp.asarray(toks), mode="prefill",
                                      cache_len=24)
    cache = {k: {n: torch.from_numpy(np.array(v)) for n, v in e.items()}
             for k, e in _np(r_cache).items()}
    nxt = np.array([[3], [7]], np.int32)
    pos = np.array([16, 11], np.int32)
    r_logits, _, _ = ref_model.forward(
        ref_cfg, rules, ref_p, jnp.asarray(nxt), mode="decode",
        cache=r_cache, pos=jnp.asarray(pos), cache_len=24)
    logits, _ = model.forward(cfg, p, torch.from_numpy(nxt).long(),
                              mode="decode", cache=cache,
                              pos=torch.from_numpy(pos))
    _close(logits.numpy(), r_logits, LOGIT_TOL, "per-row decode")


# ---------------------------------------------------------------------------
# Servers
# ---------------------------------------------------------------------------


def _server(arch, max_cache=64, **kw):
    cfg, _, p, _, _ = _model(arch)
    return VortexServer(cfg, max_cache=max_cache, params=p, device="cpu",
                        hardware="tpu_v5e", **kw)


def _toks(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_unaligned_prompt_gives_the_unpadded_greedy_tokens(arch):
    """C11: 13 real rows in a 16-row bucket, and 5 in a 16-row bucket."""
    srv = _server(arch)
    for b, s in ((2, 13), (1, 5)):
        assert srv.seq_bucket(s) > s
        toks = _toks(srv.cfg, b, s, s)
        got = srv.generate(Request(tokens=toks, max_new=6))
        np.testing.assert_array_equal(got, _greedy_unpadded(arch, toks, 6))
    assert srv.kv_pool.stats()["leases_active"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_server_scans_the_pad_into_the_state(arch):
    """Pins C11 in the reference: its tokens at an unaligned prompt are not
    the unpadded greedy decode's, and at an aligned one they are."""
    _, ref_cfg, _, _, _ = _model(arch)
    ref = RefServer(ref_cfg, make_host_mesh(), max_cache=64, seed=0)
    unaligned = _toks(ref_cfg, 2, 13, 13)
    assert not np.array_equal(
        ref.generate(RefRequest(tokens=unaligned, max_new=6)),
        _greedy_unpadded(arch, unaligned, 6))
    aligned = _toks(ref_cfg, 2, 16, 16)
    np.testing.assert_array_equal(
        ref.generate(RefRequest(tokens=aligned, max_new=6)),
        _greedy_unpadded(arch, aligned, 6))


@pytest.mark.parametrize("arch", ARCHS)
def test_counters_match_the_reference_server(arch):
    """The same requests on both servers (an aligned prompt, an unaligned
    one, and one whose decode grows the cache from kv bucket 128 to 256):
    bucket counters and decode_stats identical, and the tokens at the
    aligned prompt."""
    _, ref_cfg, _, _, _ = _model(arch)
    srv = _server(arch, max_cache=256)
    ref = RefServer(ref_cfg, make_host_mesh(), max_cache=256, seed=0)
    ref.params = _model(arch)[3]
    reqs = [(2, 16, 4), (1, 13, 4), (1, 125, 6)]
    for b, s, n in reqs:
        toks = _toks(ref_cfg, b, s, 100 + s)
        got = srv.generate(Request(tokens=toks, max_new=n))
        want = ref.generate(RefRequest(tokens=toks, max_new=n))
        if s == srv.seq_bucket(s):
            np.testing.assert_array_equal(got, want)
    assert ref.stats == {
        "prefill_compiles": srv.stats["prefill_buckets"],
        "bucket_hits": srv.stats["bucket_hits"],
        "decode_compiles": srv.stats["decode_buckets"],
        "decode_bucket_hits": srv.stats["decode_bucket_hits"],
        "chained_prefills": srv.stats["chained_prefills"],
    }
    assert srv.decode_stats.as_dict() == ref.decode_stats.as_dict()
    assert srv.decode_stats.unaligned_calls == 1  # the one growth
    # Only the attention layers' k/v grow; Mamba state passes through.
    n_attn = sum(sp.mixer == "attn" for sp in srv.cfg.pattern)
    assert srv.decode_stats.stage_copies == 2 * n_attn
    assert srv.kv_pool.stats()["leases_active"] == 0


def _stub_capture(monkeypatch, server):
    """A CUDA graph's contract on the CPU (tests/test_torch_graphs.py):
    capture runs the step once, a replay recomputes it into the static
    outputs and leaves no host counter moved."""
    counters = graphs.StepCounters(server.engine)

    class Graph:
        def __init__(self, fn, outputs):
            self.fn, self.outputs = fn, outputs

        def replay(self):
            before = counters.read()
            out = self.fn()
            counters.add(graphs.StepCounters.diff(before, counters.read()),
                         sign=-1)
            for static, new in zip(self.outputs, out):
                static.copy_(new)

    def capture(fn, pool, stream):
        out = fn()
        return Graph(fn, out), out

    monkeypatch.setattr(graphs, "capture_graph", capture)


@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_steps_carry_the_state_as_the_eager_steps(arch, monkeypatch):
    """With graphs on (stub capture), a decode step's warm-up and capture
    leave the Mamba state as they found it and each replay advances it
    once: every step's logits equal the eager server's from a copy of the
    same prefill cache, through a growth of the kv bucket, and
    ``generate()`` gives the same tokens."""
    graphed = _server(arch, max_cache=256, graphs=True)
    eager = _server(arch, max_cache=256, graphs=False)
    _stub_capture(monkeypatch, graphed)
    toks = _toks(graphed.cfg, 2, 125, 5)
    tok, cache, kvb = graphed.prefill(toks)
    copy = {k: {n: t.clone() for n, t in e.items()} for k, e in cache.items()}
    eager.adopt_cache(copy)
    t, pos = tok[:, None], 124
    try:
        for _ in range(6):
            pos += 1
            if pos + 1 > kvb:
                kvb = graphed._grown_kv_bucket(kvb, pos + 1)
                cache = graphed._grow_cache(cache, kvb)
                copy = eager._grow_cache(copy, kvb)
            a = graphed._decode(cache, t, pos, graphed._decode_seen, kvb)
            b = eager._decode(copy, t, pos, eager._decode_seen, kvb)
            assert torch.equal(a, b), pos
            t = a.argmax(-1)[:, None]
    finally:
        graphed.release_cache(cache)
        eager.release_cache(copy)
    assert graphed.stats["decode_graph_replays"] == 6
    assert graphed.stats["decode_graph_captures"] == 2  # kv 128, then 256
    req = Request(tokens=_toks(graphed.cfg, 1, 13, 6), max_new=5)
    np.testing.assert_array_equal(graphed.generate(req), eager.generate(req))
    assert graphed.stats["prefill_graph_replays"] == 2
    assert graphed.kv_pool.stats()["leases_active"] == 0
