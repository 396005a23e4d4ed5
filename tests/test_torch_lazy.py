"""Lazy bucket handles and the chained prefill, held against the JAX
package (the port's counterpart of tests/test_lazy_handles.py).

* :class:`LazyBucket` semantics: true-shape reporting, one cached counted
  slice on realization (identity when aligned), shared accounting across
  ``rewrap``/``map``/``clamp``, the ``__torch_function__`` protocol, and
  ``lazy_map``'s compatibility and fallback rules.
* Forwarding on the ``tpu_v5e`` lattice, port and JAX package side by
  side: a dispatch whose operand is a handle in a compatible bucket
  consumes the raw buffer (``forwarded``), with NaN-poisoned pad tails, for
  gemm, prefill attention and decode attention; restaging and the
  mixed handle/plain fallback.  Every counter delta equals the
  reference's; outputs are bit-identical to the port's own per-op plain
  calls and agree with the reference's within 1e-5 of their scale (aten
  and XLA:CPU sum in different orders).
* ``VortexServer(prefill="chained")`` on the smoke config in float32 with
  the reference's weights (``params_from_numpy``): ``chain_seq_bucket``,
  ``_chain_aligned`` and the per-prefill counter deltas equal the
  reference server's; a chain-aligned prefill makes 0 stage, unstage and
  realize copies and is bit-identical to ``eager=True`` on the
  ``tpu_v5e`` and ``h100_sxm`` lattices; logits agree with the
  reference's chain within 1e-4 of their scale and greedy tokens are
  identical at aligned prompts; the first token is read at the last REAL
  position s - 1 (ROADMAP C1), which the unpadded reference forward
  confirms; granite (MoE) with ``"chained"`` serves through ``"aot"``.
* The staging pool under concurrent unaligned dispatch with cap 1.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro import vortex as ref_vortex  # noqa: E402
from repro.configs.paper_gpt2 import SMOKE as REF_SMOKE  # noqa: E402
from repro.core.engine import LazyBucket as RefLazyBucket  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.serve import Request as RefRequest  # noqa: E402
from repro.launch.serve import VortexServer as RefServer  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.partitioning import make_rules  # noqa: E402

from repro_torch.configs.paper_gpt2 import SMOKE  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    DispatchStats,
    LazyBucket,
    lazy_map,
)
from repro_torch.core.workloads import GemmWorkload  # noqa: E402
from repro_torch.launch.scheduler import ContinuousScheduler  # noqa: E402
from repro_torch.launch.serve import Request, VortexServer  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params,
    params_from_numpy,
)
from repro_torch.vortex import Engine, EngineConfig  # noqa: E402

CFG = dataclasses.replace(SMOKE, dtype="float32")
REF_CFG = dataclasses.replace(REF_SMOKE, dtype="float32")
OUT_TOL = 1e-5    # engine outputs, relative to their scale
LOGIT_TOL = 1e-4  # model logits over 2 layers, as tests/test_torch_serve.py
CHAIN_KEYS = ("calls", "launches", "aligned_calls", "unaligned_calls",
              "stage_copies", "unstage_copies", "realize_slices",
              "forwarded", "padded_calls")


def _rng(seed):
    return np.random.default_rng(seed)


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in CHAIN_KEYS}


def _close(out, ref, tol=OUT_TOL):
    o = out.detach().float().numpy()
    r = np.asarray(ref, np.float32)
    assert o.shape == r.shape
    assert not np.isnan(o).any()
    assert float(np.abs(o - r).max()) <= tol * max(float(np.abs(r).max()),
                                                   1.0)


@pytest.fixture(scope="module")
def engines():
    """(port, reference) engines on the tpu_v5e lattice."""
    return (Engine(hardware="tpu_v5e", device="cpu"),
            ref_vortex.Engine(ref_vortex.EngineConfig(hardware="tpu_v5e")))


# ---------------------------------------------------------------------------
# LazyBucket unit semantics
# ---------------------------------------------------------------------------


def test_handle_reports_true_shape():
    h = LazyBucket(torch.randn(8, 5), 6, 0)
    assert h.shape == (6, 5)
    assert h.padded_extent == 8
    assert not h.is_aligned
    assert h.ndim == 2
    assert h.dtype == torch.float32


def test_realize_unaligned_slices_once_and_caches():
    st = DispatchStats()
    buf = torch.randn(4, 8, 5)
    h = LazyBucket(buf, 6, 1, st)
    r = h.realize()
    assert r.shape == (4, 6, 5) and r.is_contiguous()
    assert r.data_ptr() != buf.data_ptr()  # a dense copy, as the kernels take
    assert st.realize_slices == 1
    assert h.realize() is r  # cached: repeated forcing pays once
    assert st.realize_slices == 1
    assert torch.equal(r, buf[:, :6])


def test_realize_aligned_is_identity():
    st = DispatchStats()
    buf = torch.randn(8, 5)
    h = LazyBucket(buf, 8, 0, st)
    assert h.realize() is buf
    assert st.realize_slices == 0


def test_torch_function_protocol_forces_realization():
    st = DispatchStats()
    buf = torch.randn(8, 5)
    h = LazyBucket(buf, 6, 0, st)
    t = torch.ones(6, 5)
    assert torch.equal(torch.add(h, t), buf[:6] + 1)
    assert torch.equal(t * h, buf[:6])
    assert torch.cat([h, t]).shape == (12, 5)
    assert st.realize_slices == 1


def test_rewrap_shares_copy_accounting():
    st = DispatchStats()
    h = LazyBucket(torch.randn(8, 5), 8, 0, st)
    g = h.rewrap(torch.randn(8, 5), extent=3)
    g.realize()
    assert st.realize_slices == 1  # counted into the ORIGIN's stats


def test_map_is_row_local_and_keeps_geometry():
    st = DispatchStats()
    buf = torch.randn(8, 5)
    h = LazyBucket(buf, 6, 0, st)
    g = h.map(lambda b: b * 2.0)
    assert isinstance(g, LazyBucket)
    assert g.extent == 6 and g.padded_extent == 8
    assert torch.equal(g.buffer, buf * 2)
    with pytest.raises(ValueError, match="bucket axis"):
        h.map(lambda b: b[:4])


def test_clamp_rebuckets_without_touching_extent():
    st = DispatchStats()
    h = LazyBucket(torch.randn(8, 5), 6, 0, st)
    assert h.clamp(8) is h  # identity at the current bucket
    c = h.clamp(6)
    assert st.realize_slices == 1  # one counted boundary slice
    assert c.extent == 6 and c.padded_extent == 6 and c.is_aligned
    with pytest.raises(ValueError, match="below the true extent"):
        h.clamp(5)


def test_lazy_map_plain_compatible_and_fallback():
    a, b = torch.randn(4, 3), torch.randn(4, 3)
    assert torch.equal(lazy_map(torch.add, a, b), a + b)
    # Compatible handles: raw buffers, NaN tails confined, min extent.
    st = DispatchStats()
    b1, b2 = torch.randn(8, 5), torch.randn(8, 5)
    b1[6:] = float("nan")
    b2[4:] = float("nan")
    h1 = LazyBucket(b1, 6, 0, st)
    h2 = LazyBucket(b2, 4, 0, st)
    out = lazy_map(torch.add, h1, h2)
    assert isinstance(out, LazyBucket)
    assert out.extent == 4 and out.padded_extent == 8
    got = out.realize()
    assert not got.isnan().any()
    assert torch.equal(got, (b1 + b2)[:4])
    # Plain operands broadcast against the BUFFER shape.
    w = torch.randn(5)
    got = lazy_map(torch.mul, h1, w).buffer
    assert torch.equal(got.nan_to_num(7.0), (b1 * w).nan_to_num(7.0))
    # Incompatible bucket geometry: realize everything (counted).
    before = st.realize_slices
    h3 = LazyBucket(torch.randn(4, 5), 4, 0, st).rewrap(torch.randn(4, 5),
                                                         extent=3)
    h4 = LazyBucket(torch.randn(8, 5), 3, 0, st)
    out = lazy_map(torch.add, h3, h4)
    assert not isinstance(out, LazyBucket)
    assert out.shape == (3, 5)
    assert st.realize_slices - before == 2
    with pytest.raises(ValueError, match="bucket axis"):
        lazy_map(lambda t: t[:4], h1)


# ---------------------------------------------------------------------------
# Forwarding: bucket-to-bucket dispatch, port vs reference
# ---------------------------------------------------------------------------


def _gemm_pair(engines, n, k):
    port, ref = engines
    return (port.kernel_for(GemmWorkload(M=None, N=n, K=k)),
            ref.kernel_for(ref_vortex.make_workload("gemm", M=None, N=n,
                                                    K=k)))


def _both(kern, rkern, run):
    """Run ``run(kernel, lazy_cls, array)`` on both sides; return each
    side's (output, DispatchStats delta)."""
    out = []
    for k, cls, arr in ((kern, LazyBucket, _t),
                        (rkern, RefLazyBucket, jnp.asarray)):
        before = k.dispatch_stats.as_dict()
        res = run(k, cls, arr)
        out.append((res, _delta(before, k.dispatch_stats.as_dict())))
    return out


def test_gemm_chain_aligned_forwarding_is_bitwise(engines):
    k1, r1 = _gemm_pair(engines, 64, 96)
    k2, r2 = _gemm_pair(engines, 48, 64)
    fix = [m for m in range(1, 257)
           if k1.select(m).padded_m == m and k2.select(m).padded_m == m]
    assert fix == [m for m in range(1, 257) if r1.select(m).padded_m == m
                   and r2.select(m).padded_m == m]
    m = fix[-1]
    rng = _rng(1)
    a, w1, w2 = _np(rng, (m, 96)), _np(rng, (96, 64)), _np(rng, (64, 48))
    ref_out = k2(k1(_t(a), _t(w1)), _t(w2))

    h = k1(_t(a), _t(w1), lazy=True)
    assert isinstance(h, LazyBucket) and h.is_aligned and h.extent == m
    b2 = k2.dispatch_stats.as_dict()
    out = k2(h, _t(w2))
    d2 = _delta(b2, k2.dispatch_stats.as_dict())
    rb2 = r2.dispatch_stats.as_dict()
    rout = r2(r1(jnp.asarray(a), jnp.asarray(w1), lazy=True),
              jnp.asarray(w2))
    assert d2 == _delta(rb2, r2.dispatch_stats.as_dict())
    assert d2["forwarded"] == 1 and d2["stage_copies"] == 0
    assert d2["unstage_copies"] == 0 and d2["launches"] == 1
    assert k1.dispatch_stats.realize_slices == 0  # never forced
    assert torch.equal(out, ref_out)
    _close(out, rout)


def test_gemm_forwarding_masks_nan_tail(engines):
    k2, r2 = _gemm_pair(engines, 48, 64)
    bucket = [m for m in range(2, 257) if k2.select(m).padded_m == m][-1]
    m = next(m for m in range(bucket - 1, 0, -1)
             if k2.select(m).padded_m == bucket)
    rng = _rng(2)
    w2 = _np(rng, (64, 48))
    poisoned = _np(rng, (bucket, 64))
    plain = k2(_t(poisoned[:m]), _t(w2))
    poisoned[m:] = np.nan

    (out, d), (rout, rd) = _both(k2, r2, lambda k, cls, arr: k(
        cls(arr(poisoned), m, 0, k.dispatch_stats), arr(w2)))
    assert d == rd
    assert d["forwarded"] == 1 and d["stage_copies"] == 0
    assert d["aligned_calls"] == 1  # selection at the PADDED extent
    assert d["unstage_copies"] == 1  # finalize slices back to m rows
    assert out.shape == (m, 48)
    assert torch.equal(out, plain)
    _close(out, rout)


def test_gemm_lazy_output_defers_the_unstage(engines):
    k1, r1 = _gemm_pair(engines, 64, 96)
    m = next(m for m in range(3, 257) if k1.select(m).padded_m > m)
    rng = _rng(3)
    a, w1 = _np(rng, (m, 96)), _np(rng, (96, 64))
    plain = k1(_t(a), _t(w1))

    (h, d), (rh, rd) = _both(k1, r1, lambda k, cls, arr: k(
        arr(a), arr(w1), lazy=True))
    assert d == rd
    assert isinstance(h, LazyBucket) and not h.is_aligned
    assert d["stage_copies"] == 1 and d["launches"] == 1
    assert d["unstage_copies"] == 0 and d["realize_slices"] == 0
    assert torch.equal(h.realize(), plain)
    rh.realize()
    assert k1.dispatch_stats.realize_slices == \
        r1.dispatch_stats.realize_slices == 1


def test_incompatible_bucket_restages_and_stays_correct(engines):
    k2, r2 = _gemm_pair(engines, 48, 64)
    w = next(w for w in range(2, 257) if k2.select(w).padded_m > w)
    m = w - 1
    rng = _rng(4)
    w2 = _np(rng, (64, 48))
    poisoned = _np(rng, (w, 64))
    plain = k2(_t(poisoned[:m]), _t(w2))
    poisoned[m:] = np.nan

    (out, d), (rout, rd) = _both(k2, r2, lambda k, cls, arr: k(
        cls(arr(poisoned), m, 0, k.dispatch_stats), arr(w2)))
    assert d == rd
    assert d["forwarded"] == 0 and d["stage_copies"] == 1
    assert d["unaligned_calls"] == 1 and d["launches"] == 1
    assert torch.equal(out, plain)
    _close(out, rout)


def _attn_pair(engines, hd=32):
    port, ref = engines
    rng = _rng(5)
    shapes = ((1, 2, 8, hd), (1, 1, 8, hd), (1, 1, 8, hd))
    args = [_np(rng, s) for s in shapes]
    params = {"causal": True, "window": None, "softcap": None}
    return (port.op_kernel("attention", tuple(map(_t, args)), params),
            ref.op_kernel("attention", tuple(map(jnp.asarray, args)),
                          params))


def test_attention_forwards_nan_poisoned_kv_tails(engines):
    kern, rkern = _attn_pair(engines)
    hd = 32
    fix = [s for s in range(2, 257) if kern.select(s).bucket == (s, hd, s)]
    sb = fix[-1]
    m = next(m for m in range(sb - 1, 0, -1)
             if kern.select(m).bucket == (sb, hd, sb))
    rng = _rng(6)
    q, k, v = (_np(rng, s) for s in ((1, 2, sb, hd), (1, 1, sb, hd),
                                     (1, 1, sb, hd)))
    plain = kern(_t(q[:, :, :m]), _t(k[:, :, :m]), _t(v[:, :, :m]))
    for x in (q, k, v):
        x[:, :, m:] = np.nan

    (out, d), (rout, rd) = _both(kern, rkern, lambda kn, cls, arr: kn(
        *(cls(arr(x), m, 2, kn.dispatch_stats) for x in (q, k, v))))
    assert d == rd
    assert d["forwarded"] == 3 and d["stage_copies"] == 0
    assert d["aligned_calls"] == 1 and d["launches"] == 1
    assert out.shape == (1, 2, m, hd)
    assert torch.equal(out, plain)
    _close(out, rout)


def test_attention_mixed_handle_plain_realizes(engines):
    kern, rkern = _attn_pair(engines)
    hd = 32
    sb = max(s for s in range(2, 257) if kern.select(s).bucket == (s, hd, s))
    m = sb - 1
    rng = _rng(7)
    q = _np(rng, (1, 2, m, hd))
    k, v = _np(rng, (1, 1, sb, hd)), _np(rng, (1, 1, sb, hd))
    plain = kern(_t(q), _t(k[:, :, :m]), _t(v[:, :, :m]))
    k[:, :, m:] = np.nan
    v[:, :, m:] = np.nan

    (out, d), (rout, rd) = _both(kern, rkern, lambda kn, cls, arr: kn(
        arr(q), cls(arr(k), m, 2, kn.dispatch_stats),
        cls(arr(v), m, 2, kn.dispatch_stats)))
    assert d == rd
    assert d["realize_slices"] == 2 and d["forwarded"] == 0
    assert torch.equal(out, plain)
    _close(out, rout)


def test_decode_consumes_lazy_kv_buffers(engines):
    """Decode attention consumes NaN-tailed k/v bucket handles directly:
    the prefill chain's projection buffers read as the cache."""
    port, ref = engines
    hd = 32
    rng = _rng(8)
    rep = [_np(rng, s) for s in ((2, 4, 1, hd), (2, 2, 8, hd),
                                 (2, 2, 8, hd))]
    kern = port.op_kernel("decode_attention", (*map(_t, rep), 8), {})
    rkern = ref.op_kernel("decode_attention", (*map(jnp.asarray, rep), 8),
                          {})
    wl = kern.workload
    kvb = [s for s in range(2, 257) if wl.dynamic_bucket(kern.select(s)) == s
           ][-1]
    m = kvb - 1
    q = _np(rng, (2, 4, 1, hd))
    k, v = _np(rng, (2, 2, kvb, hd)), _np(rng, (2, 2, kvb, hd))
    plain = kern(_t(q), _t(k[:, :, :m]), _t(v[:, :, :m]), m)
    k[:, :, m:] = np.nan
    v[:, :, m:] = np.nan

    (out, d), (rout, rd) = _both(kern, rkern, lambda kn, cls, arr: kn(
        arr(q), cls(arr(k), m, 2, kn.dispatch_stats),
        cls(arr(v), m, 2, kn.dispatch_stats), m))
    assert d == rd
    assert d["forwarded"] == 2
    assert d["aligned_calls"] == 1 and d["launches"] == 1
    assert d["stage_copies"] == 0 and d["unstage_copies"] == 0
    assert torch.equal(out, plain)
    _close(out, rout)


def test_pool_eviction_never_races_in_flight():
    """cap=1 under concurrent unaligned dispatch: every result stays
    bit-identical to its serial one (a set in use is checked out, so
    eviction only ever drops idle sets), and at most one set is retained
    after the burst."""
    eng = Engine(EngineConfig(hardware="host_cpu", device="cpu",
                              empirical_levels=(), staging_pool_cap=1))
    rng = _rng(9)
    kern = eng.op_kernel("gemm", (_t(_np(rng, (5, 16))),
                                  _t(_np(rng, (16, 8)))), {})
    m = next(m for m in range(3, 257) if kern.select(m).padded_m > m)
    w = _t(_np(rng, (16, 8)))
    xs = [_t(_np(rng, (m, 16))) for _ in range(8)]
    refs = [kern(x, w) for x in xs]
    errors: list = []

    def worker(i):
        try:
            for _ in range(4):
                assert torch.equal(kern(xs[i], w), refs[i])
        except Exception as exc:  # pragma: no cover - failure path
            errors.append((i, exc))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:2]
    for entry in kern._exec_cache.values():
        assert len(entry.pool.retained) <= 1


# ---------------------------------------------------------------------------
# The chained prefill, port vs reference server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
    ref = RefServer(REF_CFG, make_host_mesh(), max_cache=256,
                    prefill="chained")
    p = params_from_numpy(
        CFG, jax.tree_util.tree_map(np.asarray, ref.params), "cpu")
    port = VortexServer(CFG, max_cache=256, params=p, device="cpu",
                        hardware="tpu_v5e", prefill="chained")
    return ref, port


def _chain_stats(engine) -> dict:
    agg = dict.fromkeys(CHAIN_KEYS, 0)
    for kind, st in engine.stats().items():
        if kind == "calibration":  # engine-level section, not a kind
            continue
        for key in agg:
            agg[key] += st[key]
    return agg


def _chain(srv, bp, sp, tokens, *, eager=False):
    """One chained prefill of either package: ``(last logits, cache,
    counter delta)``; the port reads row sp - 1, as the reference does."""
    before = _chain_stats(srv.engine)
    if isinstance(srv, VortexServer):
        toks = torch.zeros((bp, sp), dtype=torch.int64)
        toks[:, :tokens.shape[1]] = _t(tokens)
        last, cache = srv.prefill_chained(bp, sp, toks, last=sp - 1,
                                          eager=eager)
    else:
        last, cache = srv.prefill_chained(
            bp, sp, srv._make_batch(bp, sp, tokens), eager=eager)
    after = _chain_stats(srv.engine)
    return last, cache, {k: after[k] - before[k] for k in CHAIN_KEYS}


def test_prefill_knob_validated():
    with pytest.raises(ValueError, match="prefill"):
        VortexServer(CFG, device="cpu", hardware="tpu_v5e", params={},
                     prefill="nope")


def test_chain_buckets_equal_the_reference(servers):
    ref, port = servers
    assert port._prefill_chained_supported()
    assert port._chain_gemm_sigs() == ref._chain_gemm_sigs()
    for bp in (1, 2):
        for s in (5, 37, 64, 100, 128, 150, 200):
            assert port.chain_seq_bucket(s, bp) == ref.chain_seq_bucket(s, bp)
        for sp in port.seq_buckets():
            assert port._chain_aligned(bp, sp) == ref._chain_aligned(bp, sp)
    sp = port.chain_seq_bucket(100, 1)
    assert sp >= port.seq_bucket(100)
    assert port._chain_aligned(1, sp) and port.kv_bucket(sp) == sp


@pytest.mark.parametrize("s", [100, 37])
def test_chain_counters_and_logits_equal_the_reference(servers, s):
    """Per-prefill counter deltas equal the reference's exactly, at the
    chain-aligned bucket (0 boundary copies, every boundary forwarded) and
    at the plain seq bucket, where the chain is not aligned; logits agree
    within LOGIT_TOL."""
    ref, port = servers
    tokens = (np.arange(s, dtype=np.int32)[None] * 7) % CFG.vocab
    for sp in {port.chain_seq_bucket(s), port.seq_bucket(s)}:
        aligned = port._chain_aligned(1, sp)
        rlast, rcache, rd = _chain(ref, 1, sp, tokens)
        last, cache, d = _chain(port, 1, sp, tokens)
        assert d == rd, (sp, d, rd)
        copies = d["stage_copies"] + d["unstage_copies"] + d["realize_slices"]
        if aligned:
            assert copies == 0, d
            assert d["forwarded"] >= CFG.n_layers
        assert d["launches"] == 7 * CFG.n_layers + 1  # 6 gemm + attn, head
        _close(last, rlast, LOGIT_TOL)
        for pos in cache:
            for name in ("k", "v"):
                _close(cache[pos][name], rcache[pos][name], LOGIT_TOL)


@pytest.mark.parametrize("hardware", ["tpu_v5e", "h100_sxm"])
def test_chained_prefill_bitwise_vs_eager_with_zero_copies(servers,
                                                           hardware):
    _, ref_port = servers
    srv = VortexServer(CFG, max_cache=256, params=ref_port.params,
                       device="cpu", hardware=hardware, prefill="chained")
    for bp, s in ((1, 100), (2, 150)):
        sp = srv.chain_seq_bucket(s, bp)
        assert srv._chain_aligned(bp, sp)
        tokens = _rng(10).integers(0, CFG.vocab, (bp, s))
        last, cache, d = _chain(srv, bp, sp, tokens)
        assert d["stage_copies"] + d["unstage_copies"] \
            + d["realize_slices"] == 0, d
        assert d["forwarded"] >= CFG.n_layers
        last_e, cache_e, _ = _chain(srv, bp, sp, tokens, eager=True)
        assert torch.equal(last, last_e)
        kvb = srv.kv_bucket(sp)
        for pos in cache:
            for name in ("k", "v"):
                assert torch.equal(cache[pos][name], cache_e[pos][name])
                assert cache[pos][name].shape[3] == kvb
                assert cache[pos][name].dtype == torch.float32


def test_greedy_tokens_equal_the_reference_at_aligned_prompts(servers):
    ref, port = servers
    rng = _rng(11)
    for b in (1, 2):
        s = port.chain_seq_bucket(100, b)  # s == sp: both read row s - 1
        toks = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
        n0 = (port.stats["chained_prefills"], ref.stats["chained_prefills"])
        got = port.generate(Request(tokens=toks, max_new=4))
        want = ref.generate(RefRequest(tokens=toks, max_new=4))
        np.testing.assert_array_equal(got, want)
        assert port.stats["chained_prefills"] - n0[0] == \
            ref.stats["chained_prefills"] - n0[1] == 1
    assert port.stats["prefill_buckets"] == ref.stats["prefill_compiles"]


def test_chain_first_token_reads_the_last_real_position(servers):
    """s = 100 serves at chain bucket 128: the port's first token is the
    unpadded reference forward's argmax at position s - 1 (the reference
    server's chain reads the pad position sp - 1, ROADMAP C1)."""
    ref, port = servers
    rules = make_rules(make_host_mesh(), n_heads=REF_CFG.n_heads,
                       n_kv_heads=REF_CFG.n_kv_heads)
    rng = _rng(12)
    for s in (100, 150):
        assert port.chain_seq_bucket(s) > s
        toks = rng.integers(0, CFG.vocab, (2, s)).astype(np.int32)
        logits, _, _ = ref_model.forward(REF_CFG, rules, ref.params,
                                         jnp.asarray(toks), mode="train")
        want = np.asarray(jnp.argmax(logits[:, -1], -1))
        first, cache, kvb = port.prefill(toks)
        port.release_cache(cache)
        assert kvb == port.kv_bucket(port.chain_seq_bucket(s))
        np.testing.assert_array_equal(first.numpy(), want)


def test_generate_routes_chained_and_decodes(servers):
    _, srv = servers
    before = srv.stats["chained_prefills"]
    launches = srv.decode_stats.launches
    tokens = _rng(13).integers(0, CFG.vocab, (2, 37))
    out = srv.generate(Request(tokens=tokens, max_new=4))
    assert out.shape == (2, 4)
    assert srv.stats["chained_prefills"] == before + 1
    assert srv.decode_stats.launches == launches + 3
    assert srv.decode_stats.padded_calls == 0
    assert srv.kv_pool.stats()["leases_active"] == 0
    for kind, st in srv.engine_dispatch_stats().items():
        if kind in ("kv_pool", "calibration"):  # engine-level sections
            continue
        assert "forwarded" in st and "realize_slices" in st, kind


def test_scheduler_admits_through_the_chain(servers):
    """The scheduler's admissions reach the chain through ``prefill()``;
    its tokens equal serial ``generate()``'s on the same server."""
    _, srv = servers
    rng = _rng(14)
    reqs = [Request(tokens=rng.integers(0, CFG.vocab, (int(b), int(s))),
                    max_new=4)
            for b, s in zip(rng.integers(1, 3, 4), rng.integers(5, 60, 4))]
    serial = [srv.generate(r) for r in reqs]
    n0 = srv.stats["chained_prefills"]
    sched = ContinuousScheduler(srv, batch_rows=4)
    rids = [sched.submit(r) for r in reqs]
    res = sched.drain()
    sched.close()
    assert srv.stats["chained_prefills"] - n0 == len(reqs)
    for rid, want in zip(rids, serial):
        np.testing.assert_array_equal(res[rid], want)
    assert srv.kv_pool.stats()["leases_active"] == 0


def test_chained_on_an_moe_model_serves_through_aot():
    from repro_torch.configs.granite_moe_1b import SMOKE as GRANITE

    cfg = dataclasses.replace(GRANITE, dtype="float32")
    p = init_params(cfg, torch.Generator().manual_seed(15), "cpu")
    chained, aot = (VortexServer(cfg, max_cache=64, params=p, device="cpu",
                                 hardware="tpu_v5e", prefill=mode)
                    for mode in ("chained", "aot"))
    assert not chained._prefill_chained_supported()
    req = Request(tokens=_rng(15).integers(0, cfg.vocab, (2, 12)),
                  max_new=3)
    np.testing.assert_array_equal(chained.generate(req), aot.generate(req))
    assert chained.stats["chained_prefills"] == 0
    assert chained.stats["prefill_buckets"] == 1
