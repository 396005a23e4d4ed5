"""Continuous batching in the port must be invisible in the outputs
(mirrors tests/test_scheduler.py).

The step scheduler packs concurrent requests into the batch dimension and
advances them with ONE mixed-progress decode step per tick: rows at
different kv positions (``pos`` a per-row vector), free slots riding at
pos 0, the shared cache leased from the kv-bucket pool.  Each test compares
against the serial ``generate()`` on the SAME server (same weights, same
prefill path): per-request tokens must match exactly, on paper-gpt2 and on
gemma2 (windowed layers read the window slice once the cache passes twice
the smoke window of 16), both at f32.  At bucket-aligned prompt lengths the
port's tokens also equal the JAX ``ContinuousScheduler``'s, weights carried
by ``params_from_numpy`` (at other lengths the reference reads the first
token at a pad position, ROADMAP C1).

Structural contract, asserted alongside identity: launches == steps,
padded_calls == 0, and the pool's lease ledger settles to 0 -- on
retirement, on exceptions and after ``close()``.
"""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.launch import serve
from repro_torch.launch.scheduler import (
    ContinuousScheduler,
    batched_decode_supported,
)
from repro_torch.launch.serve import (
    CacheOverflowError,
    DeadlineExceeded,
    KVBucketPool,
    QueueFullError,
    Request,
    RequestError,
    VortexServer,
)
from repro_torch.models.config import LayerSpec, SSMSpec
from repro_torch.models.model import abstract_cache
from repro_torch.models.registry import get_smoke_config
from repro_torch.runtime import faults

MAX_CACHE = 256
ARCHS = ("paper-gpt2-124m", "gemma2-9b")


@pytest.fixture(scope="module", params=ARCHS)
def server(request):
    cfg = dataclasses.replace(get_smoke_config(request.param),
                              dtype="float32")
    return VortexServer(cfg, max_cache=MAX_CACHE, device="cpu",
                        hardware="tpu_v5e")


def _requests(rng, n, *, lo=4, hi=60, max_new=12, rows=1):
    return [
        Request(
            tokens=rng.integers(0, 512, (rows, int(s))).astype(np.int64),
            max_new=max_new,
        )
        for s in rng.integers(lo, hi, n)
    ]


def _serial(server, reqs):
    return [server.generate(r) for r in reqs]


def _assert_clean(server, sched):
    assert sched.stats["launches"] == sched.stats["steps"]
    assert sched.stats["padded_calls"] == 0
    sched.close()
    pool = server.engine_dispatch_stats()["kv_pool"]
    assert pool["leases_active"] == 0, pool


def test_batched_matches_serial_token_identical(server):
    """Five concurrent requests of 1-2 rows at mixed prompt lengths, four
    slots: batched greedy decode reproduces the serial tokens, with at
    least one genuinely mixed-progress step, and every attention layer
    makes one per-row decode dispatch per step."""
    rng = np.random.default_rng(0)
    reqs = _requests(rng, 5, max_new=12)
    reqs[2] = Request(tokens=rng.integers(0, 512, (2, 37)).astype(np.int64),
                      max_new=12)
    serial = _serial(server, reqs)

    before = server.engine.stats()["decode_attention"]["launches"]
    sched = ContinuousScheduler(server, batch_rows=4)
    rids = [sched.submit(r) for r in reqs]
    res = sched.drain()
    for rid, ser in zip(rids, serial):
        assert np.array_equal(res[rid], ser), rid
    mixed = [
        s for s in sched.step_positions
        if len(set(s["pos"].tolist())) >= 2
    ]
    assert mixed, "no step ever served two rows at different positions"
    after = server.engine.stats()["decode_attention"]["launches"]
    assert after - before == server.cfg.n_layers * sched.stats["steps"]
    _assert_clean(server, sched)


def test_bucket_boundary_staggering(server):
    """Rows at kvb-1 / kvb / kvb+1 in ONE step: three prompts at adjacent
    lengths cross the first kv bucket boundary together, so one step
    serves a row inside the old bucket, one at it and one past it; the
    outputs still match serial."""
    rng = np.random.default_rng(1)
    base = 119
    reqs = [
        Request(
            tokens=rng.integers(0, 512, (1, base + d)).astype(np.int64),
            max_new=16,
        )
        for d in range(3)
    ]
    boundary = server.kv_bucket(server.seq_bucket(base + 2))
    assert base + 2 < boundary <= base + 16, boundary
    serial = _serial(server, reqs)

    sched = ContinuousScheduler(server, batch_rows=4)
    rids = [sched.submit(r) for r in reqs]
    res = sched.drain()
    for rid, ser in zip(rids, serial):
        assert np.array_equal(res[rid], ser), rid
    straddled = [
        s for s in sched.step_positions
        if {boundary - 1, boundary, boundary + 1} <= set(s["pos"].tolist())
    ]
    assert straddled, [sorted(s["pos"].tolist()) for s in sched.step_positions]
    # The straddling step ran at the GROWN bucket (one step, one shape).
    assert all(s["kvb"] > boundary for s in straddled)
    _assert_clean(server, sched)


def test_nan_poisoned_pool_buffers_never_read(server):
    """Park NaN-poisoned buffers of exactly the shapes the scheduler will
    lease (shared cache and growth): if any stale byte were read, the
    greedy tokens would diverge from serial.  They do not."""
    rng = np.random.default_rng(2)
    reqs = _requests(rng, 4, lo=100, hi=130, max_new=16)
    serial = _serial(server, reqs)

    sched = ContinuousScheduler(server, batch_rows=4)
    pool = server.kv_pool
    kvb = server.kv_bucket(server.seq_bucket(129))
    buckets = {kvb}
    while kvb < MAX_CACHE:
        kvb = server._grown_kv_bucket(kvb, kvb + 1)
        buckets.add(kvb)
    for b in buckets:
        spec = abstract_cache(server.cfg, sched.batch_rows, b)
        for entry in spec.values():
            for leaf in entry.values():
                key = KVBucketPool._key(leaf.shape, leaf.dtype, server.device)
                pool._free.setdefault(key, []).append(
                    torch.full(leaf.shape, float("nan"), dtype=leaf.dtype)
                )
    hits_before = pool.stats()["lease_hits"]
    rids = [sched.submit(r) for r in reqs]
    res = sched.drain()
    assert pool.stats()["lease_hits"] > hits_before, "test inert"
    for rid, ser in zip(rids, serial):
        assert np.array_equal(res[rid], ser), rid
    sched.close()
    assert pool.stats()["leases_active"] == 0


def test_multirow_request_and_stop_token(server):
    """A 2-row request occupies two slots and reassembles in row order; a
    stop token retires its row early, padding the tail with it."""
    rng = np.random.default_rng(3)
    req = Request(
        tokens=rng.integers(0, 512, (2, 24)).astype(np.int64), max_new=10
    )
    serial = server.generate(req)

    sched = ContinuousScheduler(server, batch_rows=4)
    rid = sched.submit(req)
    res = sched.drain()
    assert np.array_equal(res[rid], serial)

    stop = int(serial[0, 3])
    req2 = Request(tokens=req.tokens[:1], max_new=10, stop=stop)
    rid2 = sched.submit(req2)
    out = sched.drain()[rid2][0]
    cut = int(np.argmax(out == stop))
    assert out[cut] == stop and (out[cut:] == stop).all()
    assert np.array_equal(out[:cut], serial[0, :cut])
    _assert_clean(server, sched)


def test_admission_rejects_at_submit(server):
    """Oversized requests fail AT SUBMIT, and an over-wide request names
    the slot limit."""
    sched = ContinuousScheduler(server, batch_rows=4)
    big = Request(tokens=np.zeros((1, 200), np.int64), max_new=MAX_CACHE)
    with pytest.raises(ValueError, match="admission refused"):
        sched.submit(big)
    wide = Request(tokens=np.zeros((8, 8), np.int64), max_new=2)
    with pytest.raises(ValueError, match="batch_rows"):
        sched.submit(wide)
    assert sched.drain() == {}
    _assert_clean(server, sched)


def test_exceptions_release_leases(server, monkeypatch):
    """A decode failure mid-``generate`` settles every lease (its finally
    arm); in the scheduler it resolves the rows that shared the step to
    typed errors, and ``close()`` settles the shared cache."""
    rng = np.random.default_rng(4)
    req = Request(
        tokens=rng.integers(0, 512, (1, 20)).astype(np.int64), max_new=8
    )
    before = server.kv_pool.stats()["leases_active"]
    calls = {"n": 0}
    real = serve.decode_step

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected decode failure")
        return real(*a, **k)

    monkeypatch.setattr(serve, "decode_step", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        server.generate(req)
    assert server.kv_pool.stats()["leases_active"] == before
    calls["n"] = 0  # the scheduler's third decode step fails
    sched = ContinuousScheduler(server, batch_rows=4)
    rid = sched.submit(req)
    err = sched.drain()[rid]
    assert isinstance(err, RequestError) and err.stage == "decode"
    assert "injected" in str(err)
    _assert_clean(server, sched)


def test_unsupported_arch_refused():
    """A decoder with a non-attention mixer keeps the serial path; the
    scheduler says so up front."""
    cfg = dataclasses.replace(
        get_smoke_config("paper-gpt2-124m"),
        pattern=(LayerSpec(mixer="mamba", mlp="none"),),
        ssm=SSMSpec(d_inner=128),
    )
    assert not batched_decode_supported(cfg)
    with pytest.raises(ValueError, match="serial generate"):
        ContinuousScheduler(types.SimpleNamespace(cfg=cfg), batch_rows=2)


def test_admit_fault_isolated_to_one_request(server):
    """A pool-lease fault while admitting resolves THAT request to a typed
    error; every other request completes as serial does and the ledger
    settles."""
    rng = np.random.default_rng(6)
    reqs = _requests(rng, 3, max_new=6)
    serial = _serial(server, reqs)

    sched = ContinuousScheduler(server, batch_rows=4)
    plan = faults.FaultPlan({"pool_lease": [1]})
    with faults.installed(plan):
        rids = [sched.submit(r) for r in reqs]
        res = sched.drain()
    assert plan.fired == [("pool_lease", 1)]
    assert set(res) == set(rids)
    err = res[rids[0]]
    assert isinstance(err, RequestError)
    assert err.stage == "admit" and err.request_id == rids[0]
    for rid, ser in zip(rids[1:], serial[1:]):
        assert np.array_equal(res[rid], ser), rid
    assert sched.stats["request_errors"] == 1
    _assert_clean(server, sched)


def test_decode_fault_fails_sharers_loop_stays_serviceable(server):
    """A fault in the mixed-progress decode step fails exactly the rows
    that shared it, and the next submission on the same scheduler decodes
    normally."""
    rng = np.random.default_rng(7)
    reqs = _requests(rng, 2, max_new=6)
    serial = _serial(server, reqs)

    sched = ContinuousScheduler(server, batch_rows=4)
    # scheduler_step occurrences: admit, admit, then the decode step.
    plan = faults.FaultPlan({"scheduler_step": [3]})
    with faults.installed(plan):
        rids = [sched.submit(r) for r in reqs]
        res = sched.drain()
        assert plan.fired == [("scheduler_step", 3)]
        for rid in rids:
            assert isinstance(res[rid], RequestError)
            assert res[rid].stage == "decode"
        rid2 = sched.submit(reqs[0])
        res2 = sched.drain()
    assert np.array_equal(res2[rid2], serial[0])
    _assert_clean(server, sched)


@pytest.mark.parametrize("site", faults.PENDING)
def test_fault_plan_refuses_unthreaded_sites(site):
    """A plan naming a site no hook of the port checks yet would never
    fire, so a chaos test on it would pass vacuously: it is refused."""
    assert site in faults.SITES and site not in faults.THREADED
    with pytest.raises(ValueError, match="not threaded"):
        faults.FaultPlan({site: [1]})


def test_fault_plan_random_draws_threaded_sites_only():
    assert set(faults.THREADED) == {"pool_lease", "scheduler_step",
                                    "cache_io", "calib_measure"}
    plan = faults.FaultPlan.random(0, rate=0.5, horizon=20)
    assert set(plan.spec) == set(faults.THREADED)
    assert any(plan.spec.values())


@pytest.mark.parametrize("site", ("cache_io", "calib_measure"))
def test_calibration_faults_stay_off_the_serving_path(site, tmp_path):
    """The calibration sites under the scheduler's idle donation (mirrors
    tests/test_calibration.py's fault cases): a failed save is counted
    and the calibrated table stays installed in memory; a failed
    measurement skips that kernel.  Neither reaches a request: the tokens
    equal serial ``generate()``'s."""
    from repro_torch.vortex import Engine, EngineConfig

    cfg = dataclasses.replace(get_smoke_config("paper-gpt2-124m"),
                              dtype="float32")
    eng = Engine(EngineConfig(
        hardware="tpu_v5e", backends=("mxu",), device="cpu",
        calibration="on-idle", calibration_cache_dir=str(tmp_path)))
    srv = VortexServer(cfg, max_cache=MAX_CACHE, engine=eng)
    # The smoke model's projections are plain matmuls: one engine gemm
    # gives the calibrator a kernel to measure.
    eng.dispatch("gemm", torch.randn(33, 64), torch.randn(64, 64))
    cal = eng.calibrator
    cal.policy = dataclasses.replace(
        cal.policy, m_max=128, max_buckets=2, min_rounds=2, max_rounds=3,
        patience=1, top_k=2)
    reqs = _requests(np.random.default_rng(12), 2, max_new=4)
    serial = _serial(srv, reqs)

    sched = ContinuousScheduler(srv, batch_rows=4)
    plan = faults.FaultPlan({site: [1]})
    with faults.installed(plan):
        rids = [sched.submit(r) for r in reqs]
        res = sched.drain()
        for _ in range(8):
            if not cal.pending():
                break
            sched.step()
    assert plan.fired == [(site, 1)]
    for rid, want in zip(rids, serial):
        assert np.array_equal(res[rid], want)
    assert sched.stats["calibration_slices"] >= 1
    assert not cal.pending()
    if site == "calib_measure":
        assert cal.skipped()["gemm"] == "measurement failed"
        assert cal.stats()["applied"] == 0
    else:
        assert cal.stats()["applied"] == 1
        assert cal.counters["save_errors"] == 1
        assert not (tmp_path / os.path.basename(cal.cache_path())).exists()
        cal.save()  # the next clean save persists the table
        assert os.path.exists(cal.cache_path())
    _assert_clean(srv, sched)


def test_bounded_queue_backpressure(server):
    """``max_queue`` bounds the admission queue: the overflow submit raises
    QueueFullError, the queued request still completes."""
    rng = np.random.default_rng(8)
    reqs = _requests(rng, 2, max_new=4)
    serial = _serial(server, reqs)

    sched = ContinuousScheduler(server, batch_rows=4, max_queue=1)
    rid = sched.submit(reqs[0])
    with pytest.raises(QueueFullError, match="admission queue is full"):
        sched.submit(reqs[1])
    res = sched.drain()
    assert np.array_equal(res[rid], serial[0])
    with pytest.raises(ValueError, match="max_queue"):
        ContinuousScheduler(server, batch_rows=4, max_queue=0)
    _assert_clean(server, sched)


def test_deadline_expires_and_slot_reuse(server):
    """An already-expired deadline resolves to DeadlineExceeded before any
    decode work; the freed capacity serves the next request."""
    rng = np.random.default_rng(9)
    reqs = _requests(rng, 2, max_new=4)
    serial = _serial(server, reqs)

    sched = ContinuousScheduler(server, batch_rows=4)
    doomed = Request(tokens=reqs[0].tokens, max_new=4, deadline_s=0.0)
    rid0 = sched.submit(doomed)
    rid1 = sched.submit(reqs[1])
    res = sched.drain()
    err = res[rid0]
    assert isinstance(err, DeadlineExceeded)
    assert err.stage == "deadline" and err.request_id == rid0
    assert np.array_equal(res[rid1], serial[1])
    assert sched.stats["deadline_expired"] == 1
    rid2 = sched.submit(reqs[0])
    assert np.array_equal(sched.drain()[rid2], serial[0])
    _assert_clean(server, sched)


def test_cache_overflow_one_typed_error_both_paths(server):
    """``generate()`` and ``submit()`` refuse an impossible request with the
    same typed error, a ValueError subclass."""
    big = Request(tokens=np.zeros((1, 200), np.int64), max_new=MAX_CACHE)
    sched = ContinuousScheduler(server, batch_rows=4)
    with pytest.raises(CacheOverflowError, match="admission refused"):
        sched.submit(big)
    with pytest.raises(CacheOverflowError):
        server.generate(big)
    assert issubclass(CacheOverflowError, ValueError)
    assert sched.drain() == {}
    _assert_clean(server, sched)


def test_tokens_equal_jax_scheduler_at_aligned_prompt_lengths():
    """The port's scheduler against the JAX ``ContinuousScheduler`` on
    paper-gpt2-smoke at f32, the reference server's weights carried over:
    identical tokens per request at bucket-aligned prompt lengths."""
    jax = pytest.importorskip("jax")
    from repro.configs.paper_gpt2 import SMOKE as REF_SMOKE
    from repro.launch.mesh import make_host_mesh
    from repro.launch.scheduler import ContinuousScheduler as RefScheduler
    from repro.launch.serve import Request as RefRequest
    from repro.launch.serve import VortexServer as RefServer

    from repro_torch.models.params import params_from_numpy

    cfg = dataclasses.replace(get_smoke_config("paper-gpt2-124m"),
                              dtype="float32")
    ref = RefServer(dataclasses.replace(REF_SMOKE, dtype="float32"),
                    make_host_mesh(), max_cache=64, seed=0)
    port = VortexServer(
        cfg, max_cache=64, device="cpu", hardware="tpu_v5e",
        params=params_from_numpy(
            cfg, jax.tree_util.tree_map(np.asarray, ref.params), "cpu"),
    )
    rng = np.random.default_rng(10)
    shapes = [(1, 16), (2, 32), (1, 32)]
    toks = [rng.integers(0, 512, sh).astype(np.int32) for sh in shapes]
    for s in (16, 32):
        assert port.seq_bucket(s) == s == ref.seq_bucket(s)
    ref_sched = RefScheduler(ref, batch_rows=4)
    port_sched = ContinuousScheduler(port, batch_rows=4)
    ref_ids = [ref_sched.submit(RefRequest(tokens=t, max_new=6))
               for t in toks]
    port_ids = [port_sched.submit(Request(tokens=t.astype(np.int64),
                                          max_new=6)) for t in toks]
    want, got = ref_sched.drain(), port_sched.drain()
    for r, p in zip(ref_ids, port_ids):
        np.testing.assert_array_equal(got[p], want[r])
    _assert_clean(port, port_sched)
