"""The port's tracer (runtime/trace.py) on the CPU, on granite's smoke
configuration (attention and top-2 of 4 experts) at f32.

* Off (the default): ``span`` is the shared no-op, nothing is recorded,
  no timing event is made, no ``record_function`` range opens, and every
  captured graph has the static outputs it has without a tracer (logits
  and ``dropped_frac``), under the stub capture of
  tests/test_torch_graphs.py.
* On: the scheduler serves the same tokens; one ``vx.sched.tick`` span a
  ``step()``, one ``vx.sched.admit`` span an admission, tagged with its
  request id; the server's spans inside them; ``rows_stepped`` is the sum
  of active rows; a decode step routes active rows x top_k per MoE layer
  and hits between top_k and E experts; a prefill's counts equal a
  brute-force replay of the capacity rule over its real tokens; each
  ``vx.dispatch`` span holds its ``vx.launch``; the ``vx.*`` names show
  in a ``torch.profiler`` trace.
* The records' bounds: replay event pairs resolve lazily and return to
  their pool, spans past ``CAPACITY`` and ring slots past ``RING`` are
  counted as dropped.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import vortex
from repro_torch.configs.granite_moe_1b import SMOKE as GRANITE_SMOKE
from repro_torch.launch import graphs
from repro_torch.launch.scheduler import ContinuousScheduler
from repro_torch.launch.serve import Request, VortexServer
from repro_torch.models.layers import moe_capacity
from repro_torch.models.params import init_params
from repro_torch.runtime import trace
from repro_torch.vortex import Engine, EngineConfig

CFG = dataclasses.replace(GRANITE_SMOKE, dtype="float32")
E, K = CFG.moe.num_experts, CFG.moe.top_k
N_MOE = sum(spec.mlp == "moe" for spec in CFG.pattern) * CFG.n_groups


class _StubGraph:
    """A CUDA graph's contract on the CPU: ``replay`` recomputes the
    captured step into the static outputs, moving no host counter and
    recording nothing (a replay runs no host code)."""

    def __init__(self, fn, outputs, counters):
        self.fn, self.outputs, self.counters = fn, outputs, counters

    def replay(self):
        before = self.counters.read()
        tr, trace.ACTIVE = trace.ACTIVE, None
        try:
            out = self.fn()
        finally:
            trace.ACTIVE = tr
        self.counters.add(
            graphs.StepCounters.diff(before, self.counters.read()), sign=-1)
        for static, new in zip(self.outputs, out):
            static.copy_(new)


def _stub(monkeypatch, server):
    counters = graphs.StepCounters(server.engine)

    def capture(fn, pool, stream):
        out = fn()
        return _StubGraph(fn, out, counters), out

    monkeypatch.setattr(graphs, "capture_graph", capture)


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    yield
    trace.disable()


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(3), "cpu")


def _server(params, graphs_on=True):
    return VortexServer(CFG, max_cache=256, params=params, device="cpu",
                        hardware="tpu_v5e", graphs=graphs_on)


def _requests(seed, n=6):
    rng = np.random.default_rng(seed)
    return [Request(tokens=rng.integers(0, CFG.vocab, (int(b), int(s)))
                    .astype(np.int64), max_new=int(m))
            for b, s, m in zip(rng.integers(1, 3, n), rng.integers(3, 40, n),
                               rng.integers(2, 9, n))]


def _serve(srv, reqs, monkeypatch=None):
    """Drain ``reqs`` through a scheduler of 4 rows: (tokens per request,
    the scheduler, active rows of each step, step() calls)."""
    sched = ContinuousScheduler(srv, batch_rows=4)
    rows: list[int] = []
    calls = [0]
    if monkeypatch is not None:
        real_decode, real_step = srv.decode_vec, sched.step

        def decode_vec(cache, tokens, pos):
            rows.append(sum(r is not None for r in sched.rows))
            return real_decode(cache, tokens, pos)

        def step():
            calls[0] += 1
            return real_step()

        monkeypatch.setattr(srv, "decode_vec", decode_vec)
        monkeypatch.setattr(sched, "step", step)
    rids = [sched.submit(r) for r in reqs]
    res = sched.drain()
    sched.close()
    return [res[r] for r in rids], sched, rows, calls[0]


def _names(recs):
    return [s[0] for s in recs["spans"]]


def _all_graphs(srv):
    return [*srv.graphs._graphs.values(), *srv.prefill_graphs._graphs.values()]


# -- off ----------------------------------------------------------------------


def test_off_span_is_the_shared_noop_and_nothing_is_recorded():
    assert trace.ACTIVE is None
    assert trace.span("vx.sched.tick") is trace.NOOP
    assert trace.span("vx.dispatch", rid=3) is trace.NOOP
    with trace.span("x") as got:
        assert got is None
    assert trace.records() is None


def test_off_graphs_capture_the_parents_outputs_and_make_no_event(
        params, monkeypatch):
    made = []
    monkeypatch.setattr(trace, "_event_pair",
                        lambda device: made.append(device))
    srv = _server(params)
    _stub(monkeypatch, srv)
    _serve(srv, _requests(0))
    gs = _all_graphs(srv)
    assert srv.graphs.keys() and srv.prefill_graphs.keys()
    for g in gs:
        logits, dropped = g.outputs  # exactly the two the parent captured
        assert logits.shape[-1] == CFG.vocab_padded and dropped.dim() == 0
    assert made == [] and trace.ACTIVE is None


def test_off_opens_no_record_function(params, monkeypatch):
    srv = _server(params)
    _stub(monkeypatch, srv)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _serve(srv, _requests(1, n=3))
    assert not [e.key for e in prof.key_averages()
                if e.key.startswith("vx.")]


# -- on -----------------------------------------------------------------------


@pytest.mark.parametrize("graphs_on", [True, False], ids=["graphed", "eager"])
def test_on_serves_the_same_tokens(params, monkeypatch, graphs_on):
    reqs = _requests(2)
    off = _server(params, graphs_on)
    if graphs_on:
        _stub(monkeypatch, off)
    want, *_ = _serve(off, reqs)
    on = _server(params, graphs_on)
    trace.enable()
    got, *_ = _serve(on, reqs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if graphs_on:
        for g in _all_graphs(on):
            assert len(g.outputs) == 3  # and the expert choices
            assert g.outputs[2].shape[:1] == (N_MOE,)
            assert g.outputs[2].shape[-1] == K


def test_on_spans_nest_per_tick_and_admission(params, monkeypatch):
    srv = _server(params)
    _stub(monkeypatch, srv)
    trace.enable()
    reqs = _requests(3)
    _, sched, rows, calls = _serve(srv, reqs, monkeypatch)
    recs = trace.records()
    spans = recs["spans"]
    names = _names(recs)
    assert names.count("vx.sched.tick") == calls
    admits = [s for s in spans if s[0] == "vx.sched.admit"]
    assert len(admits) == sched.stats["admitted"] == len(reqs)
    assert sorted(s[4] for s in admits) == list(range(len(reqs)))
    assert names.count("vx.serve.decode") == sched.stats["steps"]
    assert names.count("vx.serve.prefill") == len(reqs)
    # One read-back per admission and per step.
    assert names.count("vx.sched.readback") == len(reqs) + len(rows)
    for i, (name, t0, t1, parent, _) in enumerate(spans):
        assert t0 <= t1
        if name == "vx.sched.tick":
            assert parent == -1
        elif name == "vx.sched.admit":
            assert spans[parent][0] == "vx.sched.tick"
        elif name == "vx.serve.prefill":
            assert spans[parent][0] == "vx.sched.admit"
        elif name == "vx.serve.decode":
            assert spans[parent][0] == "vx.sched.tick"
        if parent >= 0:
            p = spans[parent]
            assert p[1] <= t0 and t1 <= p[2]
    assert recs["spans_dropped"] == recs["routing_dropped"] == 0
    # Replays carry their kind and the server span around them; on the
    # CPU they are untimed.
    kinds = [r[0] for r in recs["replays"]]
    assert kinds.count("decode") == sched.stats["steps"]
    assert kinds.count("prefill") == len(reqs)
    for kind, at, ms in recs["replays"]:
        assert spans[at][0] == f"vx.serve.{kind}" and ms is None


def test_rows_stepped_is_the_sum_of_active_rows(params, monkeypatch):
    srv = _server(params, graphs_on=False)
    _, sched, rows, _ = _serve(srv, _requests(4, n=8), monkeypatch)
    assert len(rows) == sched.stats["steps"]
    assert sched.stats["rows_stepped"] == sum(rows) > sched.stats["steps"]


@pytest.mark.parametrize("graphs_on", [True, False], ids=["graphed", "eager"])
def test_decode_routes_active_rows_times_top_k(params, monkeypatch,
                                               graphs_on):
    srv = _server(params, graphs_on)
    if graphs_on:
        _stub(monkeypatch, srv)
    trace.enable()
    _, sched, rows, _ = _serve(srv, _requests(5, n=8), monkeypatch)
    recs = trace.records()
    dec = [c for kind, _, c in recs["routing"] if kind == "decode"]
    assert len(dec) == len(rows) == sched.stats["steps"]
    assert moe_capacity(CFG, 1) == 1
    for counts, n in zip(dec, rows):
        assert counts.shape == (N_MOE, E)
        # C = 1 and top_k distinct experts a token: nothing drops.
        np.testing.assert_array_equal(counts.sum(1), n * K)
        hit = (counts > 0).sum(1)
        assert ((K <= hit) & (hit <= E)).all()
        assert (counts <= n).all()


def test_prefill_counts_kept_real_assignments(params):
    srv = _server(params, graphs_on=False)
    rng = np.random.default_rng(6)
    b, s = 2, 29
    tokens = rng.integers(0, CFG.vocab, (b, s)).astype(np.int64)
    trace.enable()
    _, cache, kvb = srv.prefill(tokens)
    srv.release_cache(cache)
    (kind, _, got), = trace.ACTIVE.records()["routing"]
    assert kind == "prefill"
    # The same forward's choices, and the capacity rule replayed by hand:
    # each row admits an expert's first C assignments in (token, choice)
    # order, the bucket's pad tokens included.
    bp, sp = srv.batch_bucket(b), srv.seq_bucket(s)
    toks = torch.zeros((bp, sp), dtype=torch.int64)
    toks[:b, :s] = torch.from_numpy(tokens)
    *_, topi = srv._prefill_eager(None, toks, s - 1, kvb, routing=True)
    topi = topi.numpy()
    cap = moe_capacity(CFG, sp)
    want = np.zeros((N_MOE, E), np.int64)
    dropped = 0
    for lay in range(N_MOE):
        for r in range(bp):
            seen = np.zeros(E, np.int64)
            for t in range(sp):
                for e in topi[lay, r, t]:
                    seen[e] += 1
                    real = r < b and t < s
                    if seen[e] <= cap and real:
                        want[lay, e] += 1
                    dropped += real and seen[e] > cap
    np.testing.assert_array_equal(got, want)
    assert dropped > 0  # the case exercises the capacity bound


def test_dispatch_spans_hold_their_launch():
    eng = Engine(EngineConfig(device="cpu", hardware="tpu_v5e"))
    trace.enable()
    with vortex.use(eng):
        for m in (5, 16, 33):
            vortex.ops.gemm(torch.randn(m, 64), torch.randn(64, 32))
    spans = trace.records()["spans"]
    disp = [i for i, s in enumerate(spans) if s[0] == "vx.dispatch"]
    launch = [s for s in spans if s[0] == "vx.launch"]
    assert len(disp) == len(launch) == 3
    assert sorted(s[3] for s in launch) == disp
    for s in launch:
        p = spans[s[3]]
        assert p[1] <= s[1] <= s[2] <= p[2]


def test_names_show_in_a_profiler_trace(params, monkeypatch):
    srv = _server(params)
    _stub(monkeypatch, srv)
    trace.enable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _serve(srv, _requests(7, n=3))
        with vortex.use(srv.engine):
            vortex.ops.gemm(torch.randn(9, 64), torch.randn(64, 32))
    keys = {e.key for e in prof.key_averages()}
    assert {"vx.sched.tick", "vx.sched.admit", "vx.sched.readback",
            "vx.serve.prefill", "vx.serve.decode", "vx.dispatch",
            "vx.launch"} <= keys


# -- the records' bounds ------------------------------------------------------


class _FakeEvent:
    """A CUDA timing event's contract: ``query`` is True once the device
    passed it (here: once the test says so)."""

    done = False
    syncs = 0

    def __init__(self):
        self.recorded = 0

    def record(self):
        self.recorded += 1

    def query(self):
        return _FakeEvent.done

    def synchronize(self):
        _FakeEvent.syncs += 1

    def elapsed_time(self, end):
        return 2.5


def test_replay_pairs_resolve_lazily_and_return_to_the_pool(monkeypatch):
    made = []

    def pair(device):
        made.append((_FakeEvent(), _FakeEvent()))
        return made[-1]

    monkeypatch.setattr(trace, "_event_pair", pair)
    monkeypatch.setattr(_FakeEvent, "done", False)
    monkeypatch.setattr(_FakeEvent, "syncs", 0)
    tr = trace.enable()
    dev = torch.device("cuda", 0)  # never touched: the events are fakes
    with trace.span("vx.serve.decode"):
        for _ in range(3):
            tr.replay_end(tr.replay_begin("decode", dev))
    # The device has not passed them: three pairs pending, none resolved.
    assert len(made) == 3 and _FakeEvent.syncs == 0
    assert [r[2] for r in tr.replays] == [None] * 3
    _FakeEvent.done = True
    tr.replay_end(tr.replay_begin("prefill", dev))  # resolves the three
    assert len(made) == 3  # ... and reuses one of their pairs
    assert _FakeEvent.syncs == 0
    recs = tr.records()  # waits for the last one only
    assert _FakeEvent.syncs == 1
    assert recs["replays"] == [("decode", 0, 2.5)] * 3 + [("prefill", -1,
                                                          2.5)]
    assert all(ev.recorded == 1 for p in made[:2] for ev in p)


def test_spans_past_capacity_are_counted(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 4)
    trace.enable()
    for _ in range(6):
        with trace.span("vx.dispatch"):
            pass
    recs = trace.records()
    assert len(recs["spans"]) == 4 and recs["spans_dropped"] == 2


def test_ring_overwrites_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(trace, "RING", 3)
    tr = trace.enable()
    for i in range(5):
        tr.routed("decode", torch.full((2, 4), i, dtype=torch.int32))
    recs = tr.records()
    assert recs["routing_dropped"] == 2
    assert [int(c[0, 0]) for _, _, c in recs["routing"]] == [2, 3, 4]


# -- on the card --------------------------------------------------------------


@pytest.mark.cuda
def test_on_the_card_replays_are_event_timed_and_tokens_unchanged():
    """granite's smoke model in bf16 through real CUDA graphs: the tracer
    leaves the served tokens as they are, times every replay by its event
    pair, and counts active rows x top_k per MoE layer in each decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    cfg = GRANITE_SMOKE
    reqs = _requests(8)
    off = VortexServer(cfg, max_cache=256, seed=0)
    want, *_ = _serve(off, reqs)
    on = VortexServer(cfg, max_cache=256, params=off.params)
    trace.enable()
    got, sched, _, _ = _serve(on, reqs)
    recs = trace.records()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    kinds = [r[0] for r in recs["replays"]]
    assert kinds.count("decode") == sched.stats["steps"] > 0
    assert kinds.count("prefill") == len(reqs)
    assert all(ms is not None and ms > 0 for _, _, ms in recs["replays"])
    dec = [c for kind, _, c in recs["routing"] if kind == "decode"]
    assert sum(int(c.sum()) for c in dec) == \
        sched.stats["rows_stepped"] * K * N_MOE
