"""One captured decode step per (form, batch bucket, kv bucket, cache)
and one captured prefill per (batch bucket, seq bucket, cache): the
port's CUDA-graph counterparts of the reference's AOT decode and prefill
programs (launch/graphs.py), on the CPU.

A CUDA graph needs the card, so here ``graphs.capture_graph`` is replaced
by a stub with a real graph's contract: capture runs the step once and
returns its outputs as the static ones; a replay redoes the device work
into those same tensors and runs no host code the counters could see (it
rolls back whatever the step's wrappers counted).  Against that stub:

* the cache keys on (form, bp, kvb) and every cache leaf's address: a
  request of a shape served before replays, a moved cache captures anew,
  and the LRU evicts;
* after graphed steps the engine's DispatchStats, the kernels' launch
  counters and ``decode_stats`` equal an eager run's;
* returned logits never alias the static output;
* tokens of ``generate()`` and of the scheduler equal the eager step's
  (which tests/test_torch_serve.py and test_torch_scheduler.py hold equal
  to the JAX server's), and ``generate()``'s equal the JAX server's at
  aligned prompt lengths here too;
* a failed capture raises (no eager fallback); the CPU defaults to the
  eager step, and the real capture refuses the CPU;
* prefill graphs key on (bp, sp) and the cache's addresses, refill the
  static ``last`` before each replay (two prompt lengths in one bucket
  replay one graph and read their own last rows), keep an LRU apart from
  the decode graphs', and repeated scheduler admissions of one shape
  replay; the chained prefill with graphs on writes its cache into leased
  leaves, so its decode steps replay too.

The ``cuda`` cases hold the real graphs against the eager steps on the
card, also for the MLA and Mamba smoke models (deepseek-v2, falcon-mamba,
jamba), whose decode steps write ckv/k_rope rows and advance the Mamba
state, and for whisper (``encoder_out`` written by the prefill graph, read
by the decode graphs) and internvl2 (the vision prefix).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs.gemma2_9b import SMOKE as GEMMA2_SMOKE
from repro_torch.configs.paper_gpt2 import SMOKE
from repro_torch.kernels import attention as attn_kernels
from repro_torch.launch import graphs, serve
from repro_torch.launch.scheduler import ContinuousScheduler
from repro_torch.launch.serve import Request, VortexServer
from repro_torch.models.params import init_params

CFG = dataclasses.replace(SMOKE, dtype="float32")
GEMMA2 = dataclasses.replace(GEMMA2_SMOKE, dtype="float32")


class _StubGraph:
    """A CUDA graph's contract on the CPU: ``replay`` recomputes the
    captured step into the static outputs and leaves no host counter
    moved."""

    def __init__(self, fn, outputs, counters):
        self.fn, self.outputs, self.counters = fn, outputs, counters

    def replay(self):
        before = self.counters.read()
        out = self.fn()
        self.counters.add(
            graphs.StepCounters.diff(before, self.counters.read()), sign=-1)
        for static, new in zip(self.outputs, out):
            static.copy_(new)


def _stub(monkeypatch, server, log=None):
    counters = graphs.StepCounters(server.engine)

    def capture(fn, pool, stream):
        assert stream is None  # the CPU: no capture stream
        out = fn()
        if log is not None:
            log.append(out)
        return _StubGraph(fn, out, counters), out

    monkeypatch.setattr(graphs, "capture_graph", capture)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _server(params, graphs_on, cfg=CFG, **kw):
    return VortexServer(cfg, max_cache=256, params=params, device="cpu",
                        hardware="tpu_v5e", graphs=graphs_on, **kw)


def _req(rng, b, s, max_new, cfg=CFG):
    return Request(tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int64),
                   max_new=max_new)


def test_cpu_defaults_to_the_eager_step_and_real_capture_refuses_it(params):
    assert _server(params, None).graphs is None
    assert _server(params, False).graphs is None
    srv = _server(params, True)
    with pytest.raises(RuntimeError, match="on the card only"):
        srv.generate(_req(np.random.default_rng(0), 1, 9, 3))
    assert srv.kv_pool.stats()["leases_active"] == 0


def test_graph_cache_keys_on_form_bucket_and_cache_addresses(params,
                                                             monkeypatch):
    srv = _server(params, True)
    _stub(monkeypatch, srv)
    rng = np.random.default_rng(1)
    s = 120
    kvb = srv.kv_bucket(srv.seq_bucket(s))
    req = _req(rng, 1, s, kvb - s + 4)  # grows into the next kv bucket
    first = srv.generate(req)
    keys = srv.graphs.keys()
    assert [k[:3] for k in keys] == [
        ("scalar", 1, kvb), ("scalar", 1, srv._grown_kv_bucket(kvb, kvb + 1))]
    assert srv.stats["decode_graph_captures"] == 2
    assert srv.stats["decode_graph_replays"] == req.max_new - 1
    # The same shape again leases the same leaves: replays only.
    again = srv.generate(req)
    np.testing.assert_array_equal(again, first)
    assert srv.graphs.keys() == keys
    assert srv.stats["decode_graph_captures"] == 2
    assert srv.stats["decode_graph_replays"] == 2 * (req.max_new - 1)
    # A cache at new addresses captures anew; the vector form is its own.
    tok, cache, kvb0 = srv.prefill(req.tokens)
    moved = {k: {n: leaf.clone() for n, leaf in e.items()}
             for k, e in cache.items()}
    try:
        srv._decode(moved, tok[:, None], s, srv._decode_seen)
        assert srv.stats["decode_graph_captures"] == 3
        srv.decode_vec(cache, tok[:, None],
                       torch.full((1,), s, dtype=torch.int32))
        assert srv.stats["decode_graph_captures"] == 4
        assert srv.graphs.keys()[-1][0] == "vector"
        assert srv.graphs.keys()[-2][3] != keys[0][3]
    finally:
        srv.release_cache(cache)
    assert srv.kv_pool.stats()["leases_active"] == 0


def test_graph_lru_evicts_the_least_recently_used(params, monkeypatch):
    srv = _server(params, True)
    _stub(monkeypatch, srv)
    srv.graphs.MAX_GRAPHS = 2
    rng = np.random.default_rng(2)
    for b in (1, 2, 4):
        srv.generate(_req(rng, b, 9, 3))
    assert [k[1] for k in srv.graphs.keys()] == [2, 4]
    srv.generate(_req(rng, 2, 9, 3))  # a hit moves to the MRU end
    assert [k[1] for k in srv.graphs.keys()] == [4, 2]
    assert srv.stats["decode_graph_captures"] == 3


def _counted_decode(monkeypatch, n_layers):
    """Count n_layers decode-attention launches a step where the step
    runs, as the kernels count them on the card."""
    real = serve.decode_step

    def step(*a, **k):
        attn_kernels.LAUNCHES["flash_attention_decode"] += n_layers
        return real(*a, **k)

    monkeypatch.setattr(serve, "decode_step", step)


def test_graphed_counters_equal_an_eager_run(params, monkeypatch):
    eager, graphed = _server(params, False), _server(params, True)
    _stub(monkeypatch, graphed)
    _counted_decode(monkeypatch, CFG.n_layers)
    rng = np.random.default_rng(3)
    reqs = [_req(rng, b, s, n) for b, s, n in ((1, 9, 5), (3, 30, 4),
                                              (1, 9, 5), (2, 60, 8))]
    seen = {}
    for name, srv in (("eager", eager), ("graphed", graphed)):
        kernels.reset_launch_counts()
        out = [srv.generate(r) for r in reqs]
        st = srv.engine_dispatch_stats()
        seen[name] = (out, st, kernels.launch_counts(), dict(srv.stats))
    (o_e, st_e, l_e, s_e), (o_g, st_g, l_g, s_g) = seen["eager"], \
        seen["graphed"]
    for a, b in zip(o_e, o_g):
        np.testing.assert_array_equal(a, b)
    steps = sum(r.max_new - 1 for r in reqs)
    assert l_g == l_e
    assert l_g["flash_attention_decode"] == CFG.n_layers * steps
    for kind in ("decode_attention", "attention", "decode_step"):
        assert st_g[kind] == st_e[kind], kind
    assert st_g["decode_step"]["launches"] == steps
    assert st_g["decode_attention"]["launches"] == CFG.n_layers * steps
    for key in ("decode_buckets", "decode_bucket_hits", "prefill_buckets",
                "bucket_hits"):
        assert s_g[key] == s_e[key], key
    assert s_g["decode_graph_replays"] == steps
    assert s_e["decode_graph_captures"] == s_e["decode_graph_replays"] == 0
    assert s_g["prefill_graph_replays"] == len(reqs)
    assert s_g["prefill_graph_captures"] == 3  # (1, 9) is served twice
    assert s_e["prefill_graph_captures"] == s_e["prefill_graph_replays"] == 0
    assert st_g["kv_pool"]["leases_active"] == 0


def test_returned_logits_never_alias_the_static_output(params, monkeypatch):
    srv, ref = _server(params, True), _server(params, False)
    _stub(monkeypatch, srv)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, CFG.vocab, (2, 1)))
    pos = torch.tensor([9, 9], dtype=torch.int32)
    caches = []
    for s in (srv, ref):
        _, cache, _ = s.prefill(rng.integers(0, CFG.vocab, (2, 9)))
        caches.append(cache)
    caches[1] = {k: {n: leaf.clone() for n, leaf in e.items()}
                 for k, e in caches[0].items()}
    a = srv.decode_vec(caches[0], toks, pos)
    static = srv.graphs.get(srv.graphs.keys()[0]).outputs[0]
    assert a.data_ptr() != static.data_ptr()
    want = ref.decode_vec(caches[1], toks, pos)
    assert torch.equal(a, want)
    a.fill_(float("nan"))  # the caller owns it
    b = srv.decode_vec(caches[0], toks, pos + 1)
    want = ref.decode_vec(caches[1], toks, pos + 1)
    assert torch.equal(b, want) and torch.isfinite(b).all()
    srv.release_cache(caches[0])


def test_moe_dropped_frac_is_read_from_the_graph(monkeypatch):
    from repro_torch.configs.granite_moe_1b import SMOKE as GRANITE

    cfg = dataclasses.replace(GRANITE, dtype="float32")
    p = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    eager, graphed = (_server(p, g, cfg=cfg) for g in (False, True))
    _stub(monkeypatch, graphed)
    req = _req(np.random.default_rng(5), 2, 12, 5, cfg=cfg)
    np.testing.assert_array_equal(graphed.generate(req), eager.generate(req))
    assert graphed._moe_forwards == eager._moe_forwards == 5
    assert graphed.mean_dropped_frac() == eager.mean_dropped_frac()


def test_scheduler_tokens_equal_the_eager_step(monkeypatch):
    p = init_params(GEMMA2, torch.Generator().manual_seed(6), "cpu")
    eager, graphed = (_server(p, g, cfg=GEMMA2) for g in (False, True))
    _stub(monkeypatch, graphed)
    rng = np.random.default_rng(6)
    reqs = [_req(rng, int(b), int(s), 6, cfg=GEMMA2)
            for b, s in zip(rng.integers(1, 3, 5), rng.integers(5, 40, 5))]
    got = {}
    for name, srv in (("eager", eager), ("graphed", graphed)):
        sched = ContinuousScheduler(srv, batch_rows=4)
        rids = [sched.submit(r) for r in reqs]
        res = sched.drain()
        sched.close()
        got[name] = [res[r] for r in rids]
        assert srv.kv_pool.stats()["leases_active"] == 0
        steps = sched.stats["steps"]
    for a, b in zip(got["eager"], got["graphed"]):
        np.testing.assert_array_equal(a, b)
    assert graphed.stats["decode_graph_replays"] == steps
    assert all(k[0] == "vector" for k in graphed.graphs.keys())
    # A second scheduler over the same server leases the same shared
    # leaves: its steps replay and capture nothing.
    n = graphed.stats["decode_graph_captures"]
    n_prefill = graphed.stats["prefill_graph_captures"]
    assert graphed.stats["prefill_graph_replays"] == len(reqs)
    sched = ContinuousScheduler(graphed, batch_rows=4)
    rids = [sched.submit(r) for r in reqs]
    res = sched.drain()
    sched.close()
    assert graphed.stats["decode_graph_captures"] == n
    # Repeated admissions of one (bp, sp) lease the same per-request
    # leaves and replay their prefill graph.
    assert graphed.stats["prefill_graph_captures"] == n_prefill
    assert graphed.stats["prefill_graph_replays"] == 2 * len(reqs)
    for rid, want in zip(rids, got["eager"]):
        np.testing.assert_array_equal(res[rid], want)


def test_warmup_captures_what_later_requests_replay(params, monkeypatch):
    srv = _server(params, True)
    _stub(monkeypatch, srv)
    srv.warmup(max_batch=2, m_max=32, max_new=4)
    n = srv.stats["decode_graph_captures"]
    assert n == 2 * len(srv.decode_buckets(m_max=32, max_new=4))
    n_prefill = srv.stats["prefill_graph_captures"]
    assert n_prefill == 2 * len(srv.seq_buckets(32))
    assert srv.kv_pool.stats()["leases_active"] == 0
    rng = np.random.default_rng(7)
    for b, s in ((1, 20), (2, 9), (1, 32)):
        srv.generate(_req(rng, b, s, 4))
    assert srv.stats["decode_graph_captures"] == n
    assert srv.stats["decode_graph_replays"] == 9
    assert srv.stats["prefill_graph_captures"] == n_prefill
    assert srv.stats["prefill_graph_replays"] == 3


def test_a_failed_capture_raises_and_settles_the_leases(params, monkeypatch):
    srv = _server(params, True)

    def broken(fn, pool, stream):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(graphs, "capture_graph", broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        srv.generate(_req(np.random.default_rng(8), 1, 9, 3))
    assert srv.stats["decode_graph_replays"] == 0
    assert srv.kv_pool.stats()["leases_active"] == 0


def test_tokens_equal_the_jax_server_at_aligned_prompt_lengths(monkeypatch):
    jax = pytest.importorskip("jax")
    from repro.configs.paper_gpt2 import SMOKE as REF_SMOKE
    from repro.launch.mesh import make_host_mesh
    from repro.launch.serve import Request as RefRequest
    from repro.launch.serve import VortexServer as RefServer
    from repro.models.params import init_params as ref_init

    from repro_torch.models.params import params_from_numpy

    ref_cfg = dataclasses.replace(REF_SMOKE, dtype="float32")
    ref_p = ref_init(ref_cfg, jax.random.PRNGKey(0))
    p = params_from_numpy(
        CFG, jax.tree_util.tree_map(np.asarray, ref_p), "cpu")
    ref = RefServer(ref_cfg, make_host_mesh(), max_cache=64, seed=0)
    port = VortexServer(CFG, max_cache=64, params=p, device="cpu",
                        hardware="tpu_v5e", graphs=True)
    _stub(monkeypatch, port)
    rng = np.random.default_rng(1)
    for s in (16, 32):
        toks = rng.integers(0, CFG.vocab, (2, s)).astype(np.int32)
        want = ref.generate(RefRequest(tokens=toks, max_new=5))
        np.testing.assert_array_equal(
            port.generate(Request(tokens=toks, max_new=5)), want)
    assert port.stats["decode_graph_replays"] == 8


def test_prefill_graph_keys_on_bucket_and_cache_addresses(params,
                                                         monkeypatch):
    srv, eager = _server(params, True), _server(params, False)
    _stub(monkeypatch, srv)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, CFG.vocab, (2, 20))
    bp, sp = srv.batch_bucket(2), srv.seq_bucket(20)
    first, cache, kvb = srv.prefill(toks)
    key = srv.prefill_graphs.keys()[0]
    assert key == srv._prefill_key(cache, bp, sp)
    assert key[:2] == (bp, sp)
    srv.release_cache(cache)
    again, cache, _ = srv.prefill(toks)  # the same leaves: a replay
    assert srv.stats["prefill_graph_captures"] == 1
    assert srv.stats["prefill_graph_replays"] == 2
    assert torch.equal(first, again)
    # A cache at new addresses (this one is still leased) captures anew.
    other, cache2, _ = srv.prefill(toks)
    assert srv.stats["prefill_graph_captures"] == 2
    assert srv.prefill_graphs.keys()[-1][2] != key[2]
    want, ecache, _ = eager.prefill(toks)
    for got_first in (first, again, other):
        assert torch.equal(got_first, want)
    for c in (cache, cache2):
        for name in ("k", "v"):
            leaf = c["pos0"][name][..., :20, :]
            assert torch.equal(leaf, ecache["pos0"][name][..., :20, :])
        srv.release_cache(c)
    eager.release_cache(ecache)
    assert srv.kv_pool.stats()["leases_active"] == 0
    assert srv.graphs.keys() == []  # no decode step ran


def test_prefill_graph_refills_the_static_last_row(params, monkeypatch):
    """Two prompt lengths in one seq bucket share one graph; each replay
    reads its own last real row, as the eager prefill does."""
    srv, eager = _server(params, True), _server(params, False)
    _stub(monkeypatch, srv)
    rng = np.random.default_rng(11)
    s1, s2 = 17, 30
    assert srv.seq_bucket(s1) == srv.seq_bucket(s2)
    for s in (s1, s2, s1):
        toks = rng.integers(0, CFG.vocab, (1, s))
        got, cache, _ = srv.prefill(toks)
        srv.release_cache(cache)
        want, ecache, _ = eager.prefill(toks)
        eager.release_cache(ecache)
        assert torch.equal(got, want), s
    assert srv.stats["prefill_graph_captures"] == 1
    assert srv.stats["prefill_graph_replays"] == 3
    g = srv.prefill_graphs.get(srv.prefill_graphs.keys()[0])
    assert g.inputs[1].tolist() == [s1 - 1]


def test_prefill_lru_is_apart_from_the_decode_lru(params, monkeypatch):
    srv = _server(params, True)
    _stub(monkeypatch, srv)
    srv.prefill_graphs.MAX_GRAPHS = 1
    rng = np.random.default_rng(12)
    for b in (1, 2, 4):
        srv.generate(_req(rng, b, 9, 3))
    assert [k[0] for k in srv.prefill_graphs.keys()] == [4]
    assert [k[1] for k in srv.graphs.keys()] == [1, 2, 4]
    assert srv.graphs.memory is srv.prefill_graphs.memory  # one pool
    srv.generate(_req(rng, 1, 9, 3))  # evicted: captures again
    assert srv.stats["prefill_graph_captures"] == 4
    assert srv.stats["decode_graph_captures"] == 3


def test_chained_prefill_with_graphs_leases_and_replays(params, monkeypatch):
    """``prefill="chained"`` stays eager with graphs on; it writes its
    cache into leased leaves, so a repeat shape's decode steps replay."""
    srv = _server(params, True, prefill="chained")
    ref = _server(params, False, prefill="chained")
    _stub(monkeypatch, srv)
    rng = np.random.default_rng(13)
    req = _req(rng, 2, 37, 4)
    want = ref.generate(req)
    for _ in range(2):
        np.testing.assert_array_equal(srv.generate(req), want)
    assert srv.stats["chained_prefills"] == 2
    assert srv.stats["prefill_graph_captures"] == 0
    assert srv.stats["decode_graph_captures"] == 1
    assert srv.stats["decode_graph_replays"] == 6
    assert srv.kv_pool.stats()["leases_active"] == 0


@pytest.mark.cuda
def test_graphed_prefill_bit_identical_to_eager_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    from repro_torch.models.registry import get_config

    cfg = get_config("paper-gpt2-124m")
    graphed = VortexServer(cfg, max_cache=256, seed=0)
    eager = VortexServer(cfg, max_cache=256, params=graphed.params,
                         graphs=False)
    rng = np.random.default_rng(14)
    for b, s in ((2, 60), (1, 100), (2, 50)):
        toks = rng.integers(0, cfg.vocab, (b, s))
        got, cache, _ = graphed.prefill(toks)
        want, ecache, _ = eager.prefill(toks)
        assert torch.equal(got, want), (b, s)
        for key in cache:
            for name in ("k", "v"):
                assert torch.equal(cache[key][name][..., :s, :],
                                   ecache[key][name][..., :s, :])
        graphed.release_cache(cache)
        eager.release_cache(ecache)
    assert graphed.stats["prefill_graph_replays"] == 3


@pytest.mark.cuda
def test_chained_prefill_on_the_card_is_bit_identical_to_eager():
    """The chain on the card: 0 boundary copies at its bucket, every GEMM
    and prefill-attention launch on the tensor cores, bit-identical to
    ``eager=True``, and a chained ``generate()`` replays its decode
    graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the hand-written kernels)")
    from repro_torch.models.registry import get_config

    cfg = get_config("paper-gpt2-124m")
    srv = VortexServer(cfg, max_cache=256, seed=0, prefill="chained")
    rng = np.random.default_rng(15)
    s = 100
    sp = srv.chain_seq_bucket(s)
    toks = torch.zeros((1, sp), dtype=torch.int64)
    toks[:, :s] = torch.from_numpy(rng.integers(0, cfg.vocab, (1, s)))
    toks = toks.cuda()
    srv.prefill_chained(1, sp, toks, last=s - 1)  # warm: executables
    st0 = srv.engine_dispatch_stats()["gemm"]
    n0 = kernels.launch_counts()
    last, cache = srv.prefill_chained(1, sp, toks, last=s - 1)
    n1 = kernels.launch_counts()
    st1 = srv.engine_dispatch_stats()["gemm"]
    gemms = 6 * cfg.n_layers + 1
    assert n1["vortex_gemm.tensor_core"] - n0["vortex_gemm.tensor_core"] \
        == gemms
    assert n1["flash_attention_prefill.tensor_core"] \
        - n0["flash_attention_prefill.tensor_core"] == cfg.n_layers
    assert st1["forwarded"] - st0["forwarded"] == gemms
    for key in ("stage_copies", "unstage_copies", "realize_slices"):
        assert st1[key] == st0[key], key
    last_e, cache_e = srv.prefill_chained(1, sp, toks, last=s - 1,
                                          eager=True)
    assert torch.equal(last, last_e)
    for key in cache:
        for name in ("k", "v"):
            assert torch.equal(cache[key][name], cache_e[key][name])
    req = Request(tokens=rng.integers(0, cfg.vocab, (2, s)), max_new=4)
    first = srv.generate(req)
    n = srv.stats["decode_graph_captures"]
    np.testing.assert_array_equal(srv.generate(req), first)
    assert srv.stats["decode_graph_captures"] == n
    assert srv.stats["chained_prefills"] == 2


@pytest.mark.cuda
def test_graphed_logits_bit_identical_to_eager_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    from repro_torch.models.registry import get_config

    cfg = get_config("paper-gpt2-124m")
    graphed = VortexServer(cfg, max_cache=256, seed=0)
    eager = VortexServer(cfg, max_cache=256, params=graphed.params,
                         graphs=False)
    rng = np.random.default_rng(9)
    s = 50  # ten decode steps stay inside the prefill's 64-row cache
    tok, cache, kvb = graphed.prefill(rng.integers(0, cfg.vocab, (2, s)))
    assert kvb >= s + 10
    copy = {k: {n: leaf.clone() for n, leaf in e.items()}
            for k, e in cache.items()}
    t = tok[:, None]
    for pos in range(s, s + 10):
        a = graphed._decode(cache, t, pos, graphed._decode_seen)
        b = eager._decode(copy, t, pos, eager._decode_seen)
        assert torch.equal(a, b), pos
        t = a.argmax(-1)[:, None]
    assert graphed.stats["decode_graph_replays"] == 10
    graphed.release_cache(cache)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "arch", ["deepseek-v2-236b", "falcon-mamba-7b", "jamba-v0.1-52b"])
def test_mla_and_mamba_graphed_tokens_equal_eager_on_the_card(arch):
    """Graphed prefills and decode steps (the Mamba state carried by each
    replay, ckv/k_rope rows written in place) give the eager server's
    tokens, through a growth of the kv bucket."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    from repro_torch.models.registry import get_smoke_config

    cfg = get_smoke_config(arch)
    graphed = VortexServer(cfg, max_cache=256, seed=0)
    eager = VortexServer(cfg, max_cache=256, params=graphed.params,
                         graphs=False)
    rng = np.random.default_rng(16)
    for b, s in ((1, 13), (2, 125)):
        req = _req(rng, b, s, 6, cfg)
        np.testing.assert_array_equal(graphed.generate(req),
                                      eager.generate(req))
    assert graphed.stats["decode_graph_replays"] == 10
    assert graphed.stats["prefill_graph_replays"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-26b"])
def test_encoder_and_vision_graphed_tokens_equal_eager_on_the_card(arch):
    """Graphed prefills (whisper's writing ``encoder_out`` whole) and
    decode steps (reading it at the address the graph binds) give the
    eager server's tokens, through a growth of the kv bucket."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    from repro_torch.models.registry import get_smoke_config

    cfg = get_smoke_config(arch)
    graphed = VortexServer(cfg, max_cache=256, seed=0)
    eager = VortexServer(cfg, max_cache=256, params=graphed.params,
                         graphs=False)
    rng = np.random.default_rng(17)
    for b, s in ((1, 13), (2, 125)):
        req = _req(rng, b, s, 6, cfg)
        np.testing.assert_array_equal(graphed.generate(req),
                                      eager.generate(req))
    assert graphed.stats["decode_graph_replays"] == 10
    assert graphed.stats["prefill_graph_replays"] == 2
    assert graphed.kv_pool.stats()["leases_active"] == 0
