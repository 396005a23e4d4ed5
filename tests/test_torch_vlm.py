"""internvl2-26b in the port (ROADMAP A11.3): the vision prefix, held
against the JAX package, and its refusal of a prompt shorter than the
prefix (ROADMAP C13).

The same weights (the reference's ``init_params``, carried over by
``params_from_numpy``) and the same numpy-seeded inputs go through
``repro.models`` and the port at the float32 smoke config (2 layers,
d_model 64, 4/2 heads, an 8-row vision prefix):

* the schema leaf for leaf, at CONFIG and SMOKE;
* the vision-prefix overwrite: the prefill's logits equal the reference's
  and ignore the tokens under the prefix;
* prefill then 3 decode steps against the JAX full forward, and the
  prefill routed through an engine (one causal dispatch per layer);
* C13: the reference's forward breaks at a sequence shorter than the
  prefix; the port's server refuses such a prompt with
  :class:`VisionPrefixError` before any work, and its warm-up skips the
  seq buckets shorter than the prefix;
* the server's greedy tokens and counters against the reference server
  at prompts that fill their seq bucket (elsewhere the port reads the
  first token at s - 1, ROADMAP C1), graphed (stub capture) tokens
  against eager ones, the scheduler's refusal and ``prefill="chained"``
  falling back to ``"aot"``.

Tolerances, relative to the output scale, at float32: 1e-4 for logits
through a whole model.  Greedy tokens and counters are identical.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs import internvl2_26b as ref_internvl  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.scheduler import (  # noqa: E402
    ContinuousScheduler as RefScheduler,
)
from repro.launch.serve import Request as RefRequest  # noqa: E402
from repro.launch.serve import VortexServer as RefServer  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import params as ref_params_mod  # noqa: E402
from repro.models.partitioning import make_rules  # noqa: E402
from repro.models.registry import get_smoke_config as ref_smoke  # noqa: E402

from repro_torch.configs import internvl2_26b  # noqa: E402
from repro_torch.launch import graphs  # noqa: E402
from repro_torch.launch.scheduler import ContinuousScheduler  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    Request,
    VisionPrefixError,
    VortexServer,
)
from repro_torch.models import model  # noqa: E402
from repro_torch.models import params as params_mod  # noqa: E402
from repro_torch.models.registry import get_smoke_config  # noqa: E402
from repro_torch.vortex import Engine  # noqa: E402

LOGIT_TOL = 1e-4
ARCH = "internvl2-26b"


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


def _toks(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _vision(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.vision_prefix, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("size", ["CONFIG", "SMOKE"])
def test_schema_matches_reference_leaf_for_leaf(size):
    got = [(path, d.shape, d.dtype, d.init) for path, d in
           params_mod._leaves(params_mod.model_schema(
               getattr(internvl2_26b, size)))]
    want = [(path, d.shape, d.dtype, d.init) for path, d in
            ref_params_mod._leaves(ref_params_mod.model_schema(
                getattr(ref_internvl, size)))]
    assert got == want
    assert "lm_head" in {p for p, *_ in got}  # untied head
    assert dataclasses.asdict(getattr(internvl2_26b, size)) == \
        dataclasses.asdict(getattr(ref_internvl, size))


def test_vision_prefix_overwrites_the_first_positions():
    cfg, ref_cfg, p, ref_p, rules = _model()
    nv = cfg.vision_prefix
    toks = _toks(cfg, 2, 24, 1)
    ve = _vision(cfg, 2, 2)
    want, _, _ = ref_model.forward(ref_cfg, rules, ref_p, jnp.asarray(toks),
                                   mode="prefill", cache_len=32,
                                   vision_embeds=jnp.asarray(ve))
    got, cache = model.forward(cfg, p, torch.from_numpy(toks).long(),
                               mode="prefill", cache_len=32,
                               vision_embeds=torch.from_numpy(ve))
    _close(got.numpy(), want, LOGIT_TOL, "prefill logits")
    assert set(cache) == {"pos0"}  # no encoder_out leaf
    # The tokens under the prefix are overwritten: other ones there give
    # the same logits, and without the prefix they differ.
    other = toks.copy()
    other[:, :nv] = _toks(cfg, 2, nv, 3)
    got2, _ = model.forward(cfg, p, torch.from_numpy(other).long(),
                            mode="prefill", cache_len=32,
                            vision_embeds=torch.from_numpy(ve))
    assert torch.equal(got, got2)
    plain, _ = model.forward(cfg, p, torch.from_numpy(toks).long(),
                             mode="prefill", cache_len=32)
    assert float((plain - got).abs().max()) > 1e-2


def test_prefill_then_decode_matches_the_full_forward():
    """Mirrors tests/test_decode_consistency.py: the prefix enters the
    cache in prefill; decode steps take no vision input."""
    cfg, ref_cfg, p, ref_p, rules = _model()
    toks = _toks(cfg, 2, 35, 4)
    ve = _vision(cfg, 2, 5)
    full, _, _ = ref_model.forward(ref_cfg, rules, ref_p, jnp.asarray(toks),
                                   mode="train",
                                   vision_embeds=jnp.asarray(ve))
    full = np.asarray(full)
    t = torch.from_numpy(toks).long()
    logits, cache = model.forward(cfg, p, t[:, :32], mode="prefill",
                                  cache_len=40,
                                  vision_embeds=torch.from_numpy(ve))
    _close(logits.numpy(), full[:, :32], LOGIT_TOL, "prefill")
    for pos in range(32, 35):
        logits, cache = model.forward(cfg, p, t[:, pos:pos + 1],
                                      mode="decode", cache=cache, pos=pos)
        _close(logits[:, 0].numpy(), full[:, pos], LOGIT_TOL, f"pos {pos}")


def test_engine_routes_the_prefill_attention():
    cfg, _, p, _, _ = _model()
    toks = torch.from_numpy(_toks(cfg, 2, 16, 6)).long()
    ve = torch.from_numpy(_vision(cfg, 2, 7))
    inline, _ = model.forward(cfg, p, toks, mode="prefill", cache_len=32,
                              vision_embeds=ve)
    eng = Engine(hardware="tpu_v5e", device="cpu")
    with eng.use():
        routed, _ = model.forward(cfg, p, toks, mode="prefill",
                                  cache_len=32, vision_embeds=ve)
    st = eng.stats()["attention"]
    assert st["launches"] == cfg.n_layers and st["padded_calls"] == 0
    _close(routed.numpy(), inline.numpy(), LOGIT_TOL, "routed logits")


# ---------------------------------------------------------------------------
# C13: a sequence shorter than the vision prefix
# ---------------------------------------------------------------------------


def test_reference_breaks_on_a_sequence_shorter_than_the_prefix():
    """The reference's concatenation yields ``vision_prefix`` rows when the
    sequence is shorter (src/repro/models/model.py:287-289), and the rope
    broadcast fails; at and past the prefix it runs.  The port's forward
    refuses the short case by name."""
    cfg, ref_cfg, p, ref_p, rules = _model()
    nv = cfg.vision_prefix
    for s in (nv // 2, nv, nv + 4):
        toks = _toks(cfg, 1, s, 8)
        ve = _vision(cfg, 1, 9)
        kw = dict(mode="prefill", cache_len=16)
        if s < nv:
            with pytest.raises(TypeError, match="incompatible shapes"):
                ref_model.forward(ref_cfg, rules, ref_p, jnp.asarray(toks),
                                  vision_embeds=jnp.asarray(ve), **kw)
            with pytest.raises(ValueError, match="vision prefix"):
                model.forward(cfg, p, torch.from_numpy(toks).long(),
                              vision_embeds=torch.from_numpy(ve), **kw)
            continue
        want, _, _ = ref_model.forward(ref_cfg, rules, ref_p,
                                       jnp.asarray(toks),
                                       vision_embeds=jnp.asarray(ve), **kw)
        got, _ = model.forward(cfg, p, torch.from_numpy(toks).long(),
                               vision_embeds=torch.from_numpy(ve), **kw)
        _close(got.numpy(), want, LOGIT_TOL, f"s {s}")


def _server(max_cache=256, cfg=None, **kw):
    c, _, p, _, _ = _model()
    return VortexServer(cfg or c, max_cache=max_cache, params=p,
                        device="cpu", hardware="tpu_v5e", **kw)


def _ref_server(max_cache=256):
    _, ref_cfg, _, ref_p, _ = _model()
    ref = RefServer(ref_cfg, make_host_mesh(), max_cache=max_cache, seed=0)
    ref.params = ref_p
    return ref


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


@pytest.mark.parametrize("graphs_on", [False, True], ids=["eager", "graphs"])
def test_server_refuses_a_prompt_shorter_than_the_prefix(graphs_on,
                                                          monkeypatch):
    srv = _server(graphs=graphs_on)
    if graphs_on:
        _stub_capture(monkeypatch, srv)
    cfg = srv.cfg
    short = Request(tokens=_toks(cfg, 1, cfg.vision_prefix - 1, 10),
                    max_new=4)
    for call in (lambda: srv.generate(short),
                 lambda: srv.prefill(short.tokens)):
        with pytest.raises(VisionPrefixError, match="vision_prefix"):
            call()
    assert srv.stats["prefill_buckets"] == 0  # nothing was served
    assert srv.kv_pool.stats() == VortexServer(
        cfg, max_cache=8, params={}, device="cpu").kv_pool.stats()
    ok = Request(tokens=_toks(cfg, 1, cfg.vision_prefix, 11), max_new=4)
    assert srv.generate(ok).shape == (1, 4)
    assert srv.kv_pool.stats()["leases_active"] == 0


def test_warmup_skips_seq_buckets_shorter_than_the_prefix(monkeypatch):
    """A 24-row prefix: the 16-row bucket can serve no prompt, so warm-up
    captures no prefill there, where the reference's warm-up breaks."""
    cfg, ref_cfg, p, ref_p, _ = _model()
    cfg24 = dataclasses.replace(cfg, vision_prefix=24)
    srv = _server(max_cache=64, cfg=cfg24, graphs=True)
    _stub_capture(monkeypatch, srv)
    assert srv.seq_buckets(64) == [16, 32, 64]
    srv.warmup(max_batch=1, max_new=4)
    assert sorted(k[1] for k in srv.prefill_graphs.keys()) == [32, 64]
    assert srv.kv_pool.stats()["leases_active"] == 0
    ref = RefServer(dataclasses.replace(ref_cfg, vision_prefix=24),
                    make_host_mesh(), max_cache=64, seed=0)
    ref.params = ref_p
    with pytest.raises(TypeError, match="incompatible shapes"):
        ref.warmup(max_batch=1, max_new=4)


def test_tokens_and_counters_match_the_reference_server():
    """Prompts that fill their seq bucket (16, 32, 128); the last grows
    k/v from kv bucket 128 to 256."""
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
    assert srv.decode_stats.stage_copies == 2
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


def test_scheduler_refuses_internvl2():
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
