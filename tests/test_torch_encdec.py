"""whisper-small in the port (ROADMAP A11.3): its encoder, the decoder's
cross-attention, sinusoidal positions and the ``encoder_out`` cache leaf,
held against the JAX package.

The same weights (the reference's ``init_params``, carried over by
``params_from_numpy``) and the same numpy-seeded inputs go through
``repro.models`` and the port at the float32 smoke config (2 + 2 layers,
d_model 64, 32 encoder frames):

* the schema leaf for leaf, at CONFIG and SMOKE;
* ``_encode``, inline and under an engine (one non-causal ``attention``
  dispatch per encoder layer);
* ``attn_forward`` with cross-attention, whose query is normed from the
  mixer's NORMED input plus the self-attention output (the reference's
  quirk, src/repro/models/model.py:172-179);
* sinusoidal positions in prefill and in decode, one position for the
  batch or one per row;
* prefill then 3 decode steps against the JAX full forward;
* the server's greedy tokens and counters against the reference server
  at prompts that fill their seq bucket (elsewhere the port reads the
  first token at s - 1, ROADMAP C1);
* ``encoder_out`` through a cache growth (same address), the pool's
  leases after a retirement and after an injected ``pool_lease`` fault,
  graphed (stub capture) tokens against eager ones, the scheduler's
  refusal and ``prefill="chained"`` falling back to ``"aot"``.

Tolerances, relative to the output scale, all at float32: 1e-5 for a
layer and the encoder, 1e-4 for logits through a whole model; 1e-6
absolute for the position table at d 64 and 1e-4 at d 768 over 1500
positions (XLA's and torch's ``pow`` differ by one float32 ulp in a
frequency, which the position multiplies).  Greedy tokens and counters
are identical.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs import whisper_small as ref_whisper  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.scheduler import (  # noqa: E402
    ContinuousScheduler as RefScheduler,
)
from repro.launch.serve import Request as RefRequest  # noqa: E402
from repro.launch.serve import VortexServer as RefServer  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import params as ref_params_mod  # noqa: E402
from repro.models.partitioning import AxisRules, make_rules  # noqa: E402
from repro.models.registry import get_smoke_config as ref_smoke  # noqa: E402

from repro_torch.configs import whisper_small  # noqa: E402
from repro_torch.kernels.ref import ref_attention  # noqa: E402
from repro_torch.launch import graphs  # noqa: E402
from repro_torch.launch.scheduler import ContinuousScheduler  # noqa: E402
from repro_torch.launch.serve import Request, VortexServer  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402
from repro_torch.models import params as params_mod  # noqa: E402
from repro_torch.models.config import LayerSpec  # noqa: E402
from repro_torch.models.registry import get_smoke_config  # noqa: E402
from repro_torch.runtime import faults  # noqa: E402
from repro_torch.vortex import Engine  # noqa: E402

RULES = AxisRules(rules={}, mesh_axes=())
LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
ARCH = "whisper-small"


def _close(out, ref, tol, where):
    o = np.asarray(out, np.float32)
    r = np.asarray(ref, np.float32)
    assert o.shape == r.shape, (where, o.shape, r.shape)
    err = float(np.abs(o - r).max())
    assert err <= tol * max(float(np.abs(r).max()), 1.0), (where, err)


@functools.lru_cache(maxsize=None)
def _model():
    """(port cfg, ref cfg, port params, ref params, rules), float32."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    ref_cfg = dataclasses.replace(ref_smoke(ARCH), dtype="float32")
    ref_p = ref_params_mod.init_params(ref_cfg, jax.random.PRNGKey(0))
    p = params_mod.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, ref_p), "cpu")
    rules = make_rules(make_host_mesh(), n_heads=ref_cfg.n_heads,
                       n_kv_heads=ref_cfg.n_kv_heads)
    return cfg, ref_cfg, p, ref_p, rules


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _toks(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("size", ["CONFIG", "SMOKE"])
def test_schema_matches_reference_leaf_for_leaf(size):
    got = [(path, d.shape, d.dtype, d.init) for path, d in
           params_mod._leaves(params_mod.model_schema(
               getattr(whisper_small, size)))]
    want = [(path, d.shape, d.dtype, d.init) for path, d in
            ref_params_mod._leaves(ref_params_mod.model_schema(
                getattr(ref_whisper, size)))]
    assert got == want
    paths = {p for p, *_ in got}
    assert {"pos0/attn/xq", "pos0/attn/xk", "pos0/attn/xv", "pos0/attn/xo",
            "pos0/attn/norm_x", "encoder/final_norm",
            "encoder/layers/attn/wq", "encoder/layers/mlp/w_in"} <= paths
    assert dataclasses.asdict(getattr(whisper_small, size)) == \
        dataclasses.asdict(getattr(ref_whisper, size))


@pytest.mark.parametrize("d,n,tol", [(64, 32, 1e-6), (768, 1500, 1e-4)])
def test_sinusoid_matches_the_reference_table(d, n, tol):
    half = d // 2
    freq = 10000.0 ** (-jnp.arange(half, dtype=jnp.float32) / half)
    ang = jnp.arange(n, dtype=jnp.float32)[:, None] * freq
    want = np.asarray(jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], -1))
    got = layers.sinusoid(torch.arange(n), d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # Decode positions (b, 1): each row its own row of the table.
    rows = torch.tensor([[n - 1], [0], [n // 2]])
    np.testing.assert_allclose(layers.sinusoid(rows, d)[:, 0].numpy(),
                               want[[n - 1, 0, n // 2]], rtol=0, atol=tol)


@pytest.mark.parametrize("served", [False, True], ids=["inline", "engine"])
def test_encoder_matches_reference(served):
    cfg, ref_cfg, p, ref_p, rules = _model()
    frames = _normal(1, 2, cfg.encoder_seq, cfg.d_model)
    want = ref_model._encode(ref_cfg, rules, ref_p, jnp.asarray(frames))
    if served:
        eng = Engine(hardware="tpu_v5e", device="cpu")
        with eng.use():
            got = model._encode(cfg, p, torch.from_numpy(frames))
        st = eng.stats()["attention"]
        assert st["calls"] == st["launches"] == cfg.n_encoder_layers
        assert st["padded_calls"] == 0
        assert [k.workload.causal for k in eng.kernels().values()] == [False]
    else:
        got = model._encode(cfg, p, torch.from_numpy(frames))
    _close(got.numpy(), want, LAYER_TOL, "encoder_out")


def test_encoder_under_an_engine_at_an_unaligned_frame_count():
    """27 frames: the engine stages the non-causal call into its bucket,
    and the kv_len mask, not the causal structure, hides the pad."""
    cfg, ref_cfg, p, ref_p, rules = _model()
    cfg27 = dataclasses.replace(cfg, encoder_seq=27)
    frames = _normal(2, 2, 27, cfg.d_model)
    want = ref_model._encode(dataclasses.replace(ref_cfg, encoder_seq=27),
                             rules, ref_p, jnp.asarray(frames))
    eng = Engine(hardware="tpu_v5e", device="cpu")
    with eng.use():
        got = model._encode(cfg27, p, torch.from_numpy(frames))
    st = eng.stats()["attention"]
    assert st["launches"] == cfg.n_encoder_layers
    assert st["unaligned_calls"] == cfg.n_encoder_layers
    _close(got.numpy(), want, LAYER_TOL, "encoder_out at 27 frames")


def _layer0(tree):
    return {k: v[0] for k, v in tree["pos0"]["attn"].items()}


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_cross_attention_layer_matches_reference(mode):
    cfg, ref_cfg, p, ref_p, _ = _model()
    ap, ref_ap = _layer0(p), _layer0(ref_p)
    spec = cfg.pattern[0]
    assert spec.cross_attn
    eo = _normal(3, 2, cfg.encoder_seq, cfg.d_model)
    s, clen = 13, 16
    h = _normal(4, 2, s, cfg.d_model)
    r_y, r_cache = ref_layers.attn_forward(
        ref_ap, jnp.asarray(h), ref_cfg, ref_cfg.pattern[0], RULES,
        mode="prefill", positions=jnp.arange(s), cache_len=clen,
        use_rope=False, encoder_out=jnp.asarray(eo))
    y, cache = layers.attn_forward(
        ap, torch.from_numpy(h), cfg, spec, mode="prefill",
        positions=torch.arange(s), cache_len=clen,
        encoder_out=torch.from_numpy(eo))
    if mode == "prefill":
        _close(y.numpy(), r_y, LAYER_TOL, "prefill y")
        for name in ("k", "v"):
            _close(cache[name].numpy(), r_cache[name], LAYER_TOL, name)
        return
    hd = _normal(5, 2, 1, cfg.d_model)
    pos = np.array([s, s - 2], np.int32)  # a position per row
    r_y, r_new = ref_layers.attn_forward(
        ref_ap, jnp.asarray(hd), ref_cfg, ref_cfg.pattern[0], RULES,
        mode="decode", cache=r_cache, pos=jnp.asarray(pos), cache_len=clen,
        use_rope=False, encoder_out=jnp.asarray(eo))
    pos_t = torch.from_numpy(pos)
    y, new = layers.attn_forward(
        ap, torch.from_numpy(hd), cfg, spec, mode="decode",
        positions=pos_t.reshape(2, 1), cache=cache, pos=pos_t,
        encoder_out=torch.from_numpy(eo))
    assert new is cache
    _close(y.numpy(), r_y, LAYER_TOL, "decode y")
    for name in ("k", "v"):
        _close(cache[name].numpy(), r_new[name], LAYER_TOL, name)


def test_cross_attention_queries_the_normed_mixer_input():
    """The cross-attention's query is ``norm(h + y_self)`` with ``h`` the
    layer's normed input that the mixer got, not the residual stream the
    decoder carries: the model hands ``attn_forward`` the normed ``h``
    (src/repro/models/model.py:172-179), and the port keeps that."""
    cfg, _, p, _, _ = _model()
    ap = _layer0(p)
    norm_w = p["pos0"]["norm_mixer"][0]
    resid = torch.from_numpy(_normal(6, 2, 9, cfg.d_model, scale=3.0)) + 1.0
    eo = torch.from_numpy(_normal(7, 2, cfg.encoder_seq, cfg.d_model))
    h = layers.norm(resid, norm_w, cfg)
    kw = dict(mode="prefill", positions=torch.arange(9), cache_len=9)
    y, _ = layers.attn_forward(ap, h, cfg, cfg.pattern[0], encoder_out=eo,
                               **kw)
    y_self, _ = layers.attn_forward(ap, h, cfg, LayerSpec(mixer="attn"),
                                    **kw)

    def cross(q_in):
        H, hd = cfg.n_heads, cfg.resolved_head_dim
        xn = layers.norm(q_in, ap["norm_x"], cfg)

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], H, hd).transpose(1, 2)

        o = ref_attention(heads(xn @ ap["xq"]), heads(eo @ ap["xk"]),
                          heads(eo @ ap["xv"]), causal=False)
        return o.transpose(1, 2).reshape(q_in.shape) @ ap["xo"]

    _close((y - y_self).numpy(), cross(h + y_self).numpy(), LAYER_TOL,
           "cross part from norm(h + y_self)")
    off = float((cross(resid + y_self) - (y - y_self)).abs().max())
    assert off > 1e-2  # the residual stream would give another answer

    # Through the whole model: a decoder layer hands its mixer the normed
    # input, so the port's logits equal the reference's (below, and in
    # test_prefill_then_decode_matches_the_full_forward).
    cfg_, ref_cfg, p_, ref_p, rules = _model()
    toks = _toks(cfg_, 2, 16, 8)
    frames = _normal(9, 2, cfg_.encoder_seq, cfg_.d_model)
    want, _, _ = ref_model.forward(ref_cfg, rules, ref_p, jnp.asarray(toks),
                                   mode="train",
                                   encoder_frames=jnp.asarray(frames))
    got, _ = model.forward(cfg_, p_, torch.from_numpy(toks).long(),
                           mode="prefill", cache_len=16,
                           encoder_frames=torch.from_numpy(frames))
    _close(got.numpy(), want, LOGIT_TOL, "logits")


@pytest.mark.parametrize("form", ["scalar", "per_row"])
def test_prefill_then_decode_matches_the_full_forward(form):
    """Mirrors tests/test_decode_consistency.py: the cache's
    ``encoder_out`` feeds every decode step's cross-attention, and each
    step's positions are sinusoids of the device ``pos``."""
    cfg, ref_cfg, p, ref_p, rules = _model()
    toks = _toks(cfg, 2, 35, 10)
    frames = _normal(11, 2, cfg.encoder_seq, cfg.d_model)
    full, _, _ = ref_model.forward(ref_cfg, rules, ref_p, jnp.asarray(toks),
                                   mode="train",
                                   encoder_frames=jnp.asarray(frames))
    full = np.asarray(full)
    t = torch.from_numpy(toks).long()
    logits, cache = model.forward(cfg, p, t[:, :32], mode="prefill",
                                  cache_len=40,
                                  encoder_frames=torch.from_numpy(frames))
    _close(logits.numpy(), full[:, :32], LOGIT_TOL, "prefill")
    enc = model._encode(cfg, p, torch.from_numpy(frames))
    assert torch.equal(cache["encoder_out"], enc)
    for i in range(3):
        if form == "scalar":
            pos = [32 + i, 32 + i]
            logits, cache = model.forward(cfg, p, t[:, 32 + i:33 + i],
                                          mode="decode", cache=cache,
                                          pos=32 + i)
        else:  # row 1 two positions behind (rewriting its own rows)
            pos = [32 + i, 30 + i]
            tok = torch.stack([t[0, pos[0]], t[1, pos[1]]])[:, None]
            logits, cache = model.forward(
                cfg, p, tok, mode="decode", cache=cache,
                pos=torch.tensor(pos, dtype=torch.int32))
        want = full[[0, 1], pos]
        _close(logits[:, 0].numpy(), want, LOGIT_TOL, f"step {i} {pos}")


def test_engine_routes_encoder_and_decoder_prefill_attention():
    """The whole-model prefill under a session (as the reference's
    tests/test_encoder_engine.py): each encoder layer makes one
    non-causal dispatch, each decoder layer one causal one, and the
    logits equal the sessionless forward's within LOGIT_TOL."""
    cfg, _, p, _, _ = _model()
    toks = torch.from_numpy(_toks(cfg, 2, 16, 12)).long()
    frames = torch.from_numpy(_normal(13, 2, cfg.encoder_seq, cfg.d_model))
    inline, _ = model.forward(cfg, p, toks, mode="prefill", cache_len=32,
                              encoder_frames=frames)
    eng = Engine(hardware="tpu_v5e", device="cpu")
    with eng.use():
        routed, _ = model.forward(cfg, p, toks, mode="prefill",
                                  cache_len=32, encoder_frames=frames)
    launches = {k.workload.causal: k.dispatch_stats.launches
                for k in eng.kernels().values()}
    assert launches == {False: cfg.n_encoder_layers, True: cfg.n_layers}
    _close(routed.numpy(), inline.numpy(), LOGIT_TOL, "routed logits")


def test_prefill_needs_encoder_frames():
    cfg, _, p, _, _ = _model()
    with pytest.raises(ValueError, match="encoder_frames"):
        model.forward(cfg, p, torch.zeros((1, 16), dtype=torch.long),
                      mode="prefill", cache_len=16)


def _server(max_cache=256, **kw):
    cfg, _, p, _, _ = _model()
    return VortexServer(cfg, max_cache=max_cache, params=p, device="cpu",
                        hardware="tpu_v5e", **kw)


def _ref_server(max_cache=256):
    _, ref_cfg, _, ref_p, _ = _model()
    ref = RefServer(ref_cfg, make_host_mesh(), max_cache=max_cache, seed=0)
    ref.params = ref_p
    return ref


def test_tokens_and_counters_match_the_reference_server():
    """Prompts that fill their seq bucket (16, 32, 128); the last grows
    k/v from kv bucket 128 to 256 while ``encoder_out`` passes through."""
    cfg = _model()[0]
    srv, ref = _server(), _ref_server()
    for b, s, n in ((2, 16, 4), (1, 32, 5), (1, 128, 4)):
        assert srv.seq_bucket(s) == s
        toks = _toks(cfg, b, s, 100 + s)
        got = srv.generate(Request(tokens=toks, max_new=n))
        want = ref.generate(RefRequest(tokens=toks, max_new=n))
        np.testing.assert_array_equal(got, want)
    assert ref.stats == {
        "prefill_compiles": srv.stats["prefill_buckets"],
        "bucket_hits": srv.stats["bucket_hits"],
        "decode_compiles": srv.stats["decode_buckets"],
        "decode_bucket_hits": srv.stats["decode_bucket_hits"],
        "chained_prefills": srv.stats["chained_prefills"],
    }
    assert srv.decode_stats.as_dict() == ref.decode_stats.as_dict()
    assert srv.decode_stats.stage_copies == 2  # k and v grew, not encoder_out
    assert srv.kv_pool.stats()["leases_active"] == 0


class _StubGraph:
    """A CUDA graph's contract on the CPU: ``replay`` recomputes the
    captured step into its static outputs and moves no host counter."""

    def __init__(self, fn, outputs, counters):
        self.fn, self.outputs, self.counters = fn, outputs, counters

    def replay(self):
        before = self.counters.read()
        out = self.fn()
        self.counters.add(
            graphs.StepCounters.diff(before, self.counters.read()), sign=-1)
        for static, new in zip(self.outputs, out):
            static.copy_(new)


def _stub_capture(monkeypatch, server):
    counters = graphs.StepCounters(server.engine)

    def capture(fn, pool, stream):
        out = fn()
        return _StubGraph(fn, out, counters), out

    monkeypatch.setattr(graphs, "capture_graph", capture)


def test_encoder_out_keeps_its_address_through_a_growth(monkeypatch):
    """The leased ``encoder_out`` is the prefill graph's output and the
    decode graphs' input: a growth leases new k/v and keeps it, so the
    grown cache's decode graph binds the same address."""
    srv = _server(graphs=True)
    _stub_capture(monkeypatch, srv)
    cfg = srv.cfg
    toks = _toks(cfg, 1, 32, 14)
    tok, cache, kvb = srv.prefill(toks)
    eo = cache["encoder_out"]
    assert eo.shape == (srv.batch_bucket(1), cfg.encoder_seq, cfg.d_model)
    want = model._encode(cfg, srv.params, torch.zeros_like(eo))
    assert torch.equal(eo, want)  # written whole by the prefill graph
    grown = srv._grow_cache(cache, srv._grown_kv_bucket(kvb, kvb + 1))
    assert grown["encoder_out"] is eo
    assert grown["pos0"]["k"].data_ptr() != cache["pos0"]["k"].data_ptr()
    logits = srv._decode(grown, tok[:, None], 32, srv._decode_seen)
    (key,) = srv.graphs.keys()
    assert eo.data_ptr() in key[-1]
    assert torch.isfinite(logits).all()
    srv.release_cache(grown)
    assert srv.kv_pool.stats()["leases_active"] == 0


@pytest.mark.parametrize("at", [3, 5], ids=["prefill_lease", "growth_lease"])
def test_leases_balance_after_a_pool_lease_fault(at, monkeypatch):
    """With graphs on, a prefill leases k, v and ``encoder_out`` (leases
    1-3) and a growth k and v (4-5): a fault at either settles every lease
    taken, and the next request is served."""
    srv = _server(graphs=True)
    _stub_capture(monkeypatch, srv)
    cfg = srv.cfg
    req = Request(tokens=_toks(cfg, 1, 128, 15), max_new=4)
    plan = faults.FaultPlan({"pool_lease": [at]})
    with faults.installed(plan):
        with pytest.raises(faults.InjectedFault):
            srv.generate(req)
    assert plan.fired == [("pool_lease", at)]
    assert srv.kv_pool.stats()["leases_active"] == 0
    np.testing.assert_array_equal(srv.generate(req),
                                  _server().generate(req))
    assert srv.kv_pool.stats()["leases_active"] == 0


def test_graphed_tokens_equal_eager_tokens(monkeypatch):
    graphed = _server(graphs=True)
    _stub_capture(monkeypatch, graphed)
    eager = _server()
    cfg = graphed.cfg
    for b, s, n in ((2, 13, 4), (1, 120, 12)):
        req = Request(tokens=_toks(cfg, b, s, 16 + s), max_new=n)
        np.testing.assert_array_equal(graphed.generate(req),
                                      eager.generate(req))
    assert graphed.stats["prefill_graph_replays"] == 2
    assert graphed.stats["decode_graph_replays"] == 3 + 11
    assert graphed.kv_pool.stats()["leases_active"] == 0


def test_warmup_builds_the_encoder_attention_and_captures(monkeypatch):
    srv = _server(max_cache=64, graphs=True)
    _stub_capture(monkeypatch, srv)
    srv.warmup(max_batch=1, max_new=4)
    enc = [k for k in srv.engine.kernels().values()
           if k.workload.kind == "attention" and not k.workload.causal]
    assert len(enc) == 1 and enc[0].cache_info["entries"] >= 1
    n = srv.stats["prefill_graph_captures"]
    assert n == len(srv.seq_buckets(64))
    srv.generate(Request(tokens=_toks(srv.cfg, 1, 20, 17), max_new=3))
    assert srv.stats["prefill_graph_captures"] == n  # replayed
    assert srv.kv_pool.stats()["leases_active"] == 0


def test_scheduler_refuses_whisper():
    srv, ref = _server(max_cache=64), _ref_server(max_cache=64)
    with pytest.raises(ValueError) as got:
        ContinuousScheduler(srv)
    with pytest.raises(ValueError) as want:
        RefScheduler(ref)
    assert str(got.value) == str(want.value)
    assert "serial generate() path" in str(got.value)


def test_chained_prefill_falls_back_to_aot():
    cfg = _model()[0]
    chained = _server(max_cache=64, prefill="chained")
    assert not chained._chained()
    req = Request(tokens=_toks(cfg, 2, 13, 18), max_new=4)
    np.testing.assert_array_equal(chained.generate(req),
                                  _server(max_cache=64).generate(req))
    assert chained.stats["chained_prefills"] == 0
    assert chained.stats["prefill_buckets"] == 1

