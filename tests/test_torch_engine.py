"""The port's dispatch engine: masked-tail staging, counters, buckets.

Every registered kind runs through the same cases: gemm, prefill and
decode attention, the grouped GEMM (NaN routing pad past its per-group
counts) and conv2d (whose ``stage_view`` is the im2col).

Inside the port, staged dispatch (engine-owned buffers whose pad tails are
NaN-poisoned) must be BIT-identical to the zero-pad reference path, with
one launch per call and zero padded calls.  Against the JAX package, every
extent must land in the same bucket, and outputs agree within float32
tolerance (1e-5 of the output scale: aten and XLA:CPU sum in different
orders).  Runs with ``hardware="tpu_v5e"`` so buckets compare one for one.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro import vortex as ref_vortex  # noqa: E402

from repro_torch import vortex  # noqa: E402
from repro_torch.core import PrecompileError  # noqa: E402
from repro_torch.core.workloads import SelectionDeviationError  # noqa: E402
from repro_torch.vortex import Engine  # noqa: E402


def _engine():
    return Engine(hardware="tpu_v5e", device="cpu")


def _ref_engine():
    return ref_vortex.Engine(ref_vortex.EngineConfig(hardware="tpu_v5e"))


def _gemm_args(rng, m):
    return (rng.standard_normal((m, 64)).astype(np.float32),
            rng.standard_normal((64, 48)).astype(np.float32))


def _attn_args(rng, m):
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((2, 4, m, 16), (2, 2, m, 16), (2, 2, m, 16)))


def _decode_args(rng, m):
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, 4, 1, 16), (2, 2, m, 16), (2, 2, m, 16)))
    return q, k, v, max(m - 3, 1)


def _grouped_args(rng, m):
    # Capacity m; counts of 0, a partial count and m.  Routing pad past
    # each count is NaN, which must never reach a real row.
    x = rng.standard_normal((4, m, 16)).astype(np.float32)
    counts = np.array([0, m // 2, m, m], np.int32)
    for g, n in enumerate(counts):
        x[g, n:] = np.nan
    w = rng.standard_normal((2, 16, 12)).astype(np.float32)
    return x, w, counts


def _conv_args(rng, m):
    # A 3x3 window over (m + 2) x 3 pixels: the dynamic extent b*h'*w' is m.
    return (rng.standard_normal((1, m + 2, 3, 4)).astype(np.float32),
            rng.standard_normal((3, 3, 4, 8)).astype(np.float32))


KINDS = {
    "gemm": (_gemm_args, {}),
    "attention": (_attn_args, {"causal": True}),
    "decode_attention": (_decode_args, {}),
    "grouped_gemm": (_grouped_args, {}),
    "conv2d": (_conv_args, {}),
}


def _bucket(eng, kind, args, params):
    return vortex.CompiledOp(eng, eng.op_kernel(kind, args, params))


def _to_torch(args):
    return tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in args)


@pytest.mark.parametrize("kind", list(KINDS))
def test_staged_bit_identical_to_padded_with_poisoned_buffers(kind):
    make, params = KINDS[kind]
    eng = _engine()
    rng = np.random.default_rng(0)
    probe = _to_torch(make(rng, 5))
    op = _bucket(eng, kind, probe, params)
    b = op.bucket(40)
    kern = op.kernel
    for m in (1, b - 1, b, b + 1, 37):
        args = _to_torch(make(rng, m))
        first = eng.dispatch(kind, *args, **params)
        # Poison every retained staging set's whole buffer, then re-serve:
        # only the true extent is re-written, the NaN tail must stay unread.
        for entry in kern._exec_cache.values():
            for bufs in entry.pool.retained:
                for buf in bufs.values():
                    buf.fill_(float("nan"))
        before = kern.dispatch_stats.as_dict()
        again = eng.dispatch(kind, *args, **params)
        after = kern.dispatch_stats.as_dict()
        assert after["launches"] - before["launches"] == 1
        assert after["padded_calls"] == before["padded_calls"]
        padded = kern.call_padded(*args)
        assert torch.isfinite(again).all(), (kind, m)
        assert torch.equal(again, padded), (kind, m)
        assert torch.equal(again, first), (kind, m)


def test_counters_keep_the_reference_meanings():
    eng = _engine()
    rng = np.random.default_rng(1)
    a, b = _to_torch(_gemm_args(rng, 16))
    with vortex.use(eng):
        vortex.ops.gemm(a, b)  # 16 is a TPU bucket: aligned
        a2, b2 = _to_torch(_gemm_args(rng, 21))
        vortex.ops.gemm(a2, b2)  # unaligned: one stage + one unstage copy
    d = eng.stats()["gemm"]
    assert (d["calls"], d["launches"], d["aligned_calls"],
            d["unaligned_calls"], d["stage_copies"], d["unstage_copies"],
            d["padded_calls"]) == (2, 2, 1, 1, 1, 1, 0)
    ref = _ref_engine()
    with ref_vortex.use(ref):
        ref_vortex.ops.gemm(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
        ref_vortex.ops.gemm(jnp.asarray(a2.numpy()), jnp.asarray(b2.numpy()))
    rd = ref.stats()["gemm"]
    for key in ("calls", "launches", "aligned_calls", "unaligned_calls",
                "stage_copies", "unstage_copies", "padded_calls"):
        assert d[key] == rd[key], key


@pytest.mark.parametrize("kind", list(KINDS))
def test_same_bucket_for_every_extent_as_reference(kind):
    make, params = KINDS[kind]
    rng = np.random.default_rng(2)
    probe = make(rng, 8)
    op = _bucket(_engine(), kind, _to_torch(probe), params)
    ref = _ref_engine()
    ref_op = ref_vortex.CompiledOp(ref, ref.op_kernel(
        kind, tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                    for a in probe), params))
    for m in range(1, 260):
        assert op.bucket(m) == ref_op.bucket(m), m
    assert op.buckets(300) == ref_op.buckets(300)


@pytest.mark.parametrize("kind", list(KINDS))
def test_outputs_close_to_reference(kind):
    make, params = KINDS[kind]
    rng = np.random.default_rng(3)
    eng, ref = _engine(), _ref_engine()
    for m in (3, 16, 29):
        args = make(rng, m)
        out = eng.dispatch(kind, *_to_torch(args), **params)
        with ref_vortex.use(ref):
            r = ref.dispatch(kind, *(jnp.asarray(a) if isinstance(a, np.ndarray)
                                     else a for a in args), **params)
        r = np.asarray(r)
        assert out.shape == r.shape
        np.testing.assert_allclose(
            out.numpy(), r, rtol=0, atol=1e-5 * max(np.abs(r).max(), 1.0))


@pytest.mark.parametrize("m", [16, 21])
def test_mutating_an_output_never_changes_a_later_call(m):
    eng = _engine()
    rng = np.random.default_rng(4)
    a, b = _to_torch(_gemm_args(rng, m))
    first = eng.dispatch("gemm", a, b)
    keep = first.clone()
    first.fill_(float("nan"))  # the caller owns what it was handed
    second = eng.dispatch("gemm", a, b)
    assert torch.equal(second, keep)
    assert second.data_ptr() != first.data_ptr()


def test_precompile_builds_every_bucket_and_names_a_failing_one():
    eng = _engine()
    op = vortex.compile("gemm", engine=eng, M=None, N=48, K=64)
    n = op.precompile(128)
    assert n == len(op.kernel.selector.selections_upto(128))
    assert op.stats()["exec"]["entries"] == n

    class Broken(type(op.workload)):
        def build_executable(self, sel, *, impl):
            raise SelectionDeviationError("tile refused")

    bad = vortex.compile(Broken(M=None, N=40, K=64), engine=eng)
    with pytest.raises(PrecompileError, match="bucket="):
        bad.precompile(32)


def test_grouped_gemm_prices_on_the_gemm_lattice_like_the_reference():
    from repro.core.workloads import GroupedGemmWorkload as RefGrouped

    from repro_torch.core.workloads import GemmWorkload, GroupedGemmWorkload

    wl = GroupedGemmWorkload(C=None, G=64, E=32, N=512, K=1024)
    ref = RefGrouped(C=None, G=64, E=32, N=512, K=1024)
    assert wl.lattice_key == GemmWorkload(M=None, N=512, K=1024).signature
    assert wl.lattice_key == ref.lattice_key
    for c in (1, 20, 64):
        assert wl.flops(c) == ref.flops(c) == 2.0 * 64 * c * 512 * 1024
    # One engine shares one scored lattice between the two kinds.
    eng = _engine()
    eng.kernel_for(GemmWorkload(M=None, N=512, K=1024))
    n = len(eng._scored_cache)
    eng.kernel_for(wl)
    assert len(eng._scored_cache) == n


def test_engine_on_cpu_refuses_the_cuda_impl():
    with pytest.raises(ValueError):
        Engine(hardware="tpu_v5e", device="cpu", impl="cuda")


# ---------------------------------------------------------------------------
# EngineConfig knobs, each held against the same config through repro.vortex
# ---------------------------------------------------------------------------


def _knob_engines(**knobs):
    """The port's and the reference's engine at the same knobs (host_cpu,
    fully analytical, as the reference's knob tests run)."""
    port = Engine(vortex.EngineConfig(
        hardware="host_cpu", device="cpu", empirical_levels=(), **knobs))
    ref = ref_vortex.Engine(ref_vortex.EngineConfig(
        hardware="host_cpu", empirical_levels=(), **knobs))
    return port, ref


def test_config_table_limits_reach_the_selector():
    port, ref = _knob_engines(table_m_max=32, table_extend_limit=64)
    kern = port.compile("gemm", M=None, N=16, K=16).kernel
    rkern = ref.compile("gemm", M=None, N=16, K=16).kernel
    assert kern.selector.table.m_max == rkern.selector.table.m_max == 32
    # Beyond the extension limit: neither table grows, and both serve the
    # extent from the argmin path with the same selection.
    sel, rsel = kern.select(1000), rkern.select(1000)
    assert kern.selector.table.m_max == rkern.selector.table.m_max == 32
    assert (sel.padded_m, sel.strategy.l1) == (rsel.padded_m, rsel.strategy.l1)
    assert kern.selector.stats.argmin_misses == \
        rkern.selector.stats.argmin_misses == 1


def test_config_knob_defaults_and_validation_match_the_reference():
    port = vortex.EngineConfig(device="cpu")
    ref = ref_vortex.EngineConfig()
    for name in ("empirical_levels", "table_m_max", "table_extend_limit",
                 "precompile_m_max", "staging", "staging_pool_cap"):
        assert getattr(port, name) == getattr(ref, name), name
    cfg = vortex.EngineConfig(device="cpu", empirical_levels=[0, 1])
    assert cfg.empirical_levels == (0, 1)
    with pytest.raises(ValueError, match="staging_pool_cap"):
        vortex.EngineConfig(device="cpu", staging_pool_cap=-1)
    # The levels reach the analyzer: level 1 measured or not, as in the
    # reference's kernel at the same levels.
    for levels in ((), (0, 1)):
        eng = Engine(hardware="tpu_v5e", device="cpu",
                     empirical_levels=levels)
        rng = ref_vortex.Engine(ref_vortex.EngineConfig(
            hardware="tpu_v5e", empirical_levels=levels))
        got = eng.compile("gemm", M=None, N=16, K=16).kernel.offline_stats
        want = rng.compile("gemm", M=None, N=16, K=16).kernel.offline_stats
        assert got.num_measured == want.num_measured, levels


def test_precompile_policy_warms_unspecialized_ops_only():
    port, ref = _knob_engines(precompile_m_max=64)
    gemm = port.compile("gemm", M=None, N=16, K=16)
    rgemm = ref.compile("gemm", M=None, N=16, K=16)
    expect = len(gemm.kernel.selector.selections_upto(64))
    assert gemm.stats()["exec"]["entries"] == expect > 0
    assert rgemm.stats()["exec"]["entries"] == expect
    # Attention executables specialize on batch/head dims: eager precompile
    # without representative args would warm keys real calls never hit.
    attn = port.compile("attention", seq=None, head_dim=32)
    rattn = ref.compile("attention", seq=None, head_dim=32)
    assert attn.stats()["exec"]["entries"] == 0
    assert rattn.stats()["exec"]["entries"] == 0
    # A second compile of a known signature warms nothing more.
    port.compile("gemm", M=None, N=16, K=16)
    assert gemm.stats()["exec"]["entries"] == expect


@pytest.mark.parametrize("kind", list(KINDS))
def test_staging_disabled_knob_matches_staged_outputs(kind):
    """``staging=False`` sends every call to the zero-pad reference path:
    outputs bit-identical to staged dispatch, no launch or copy counted,
    and the same counters as the reference's staging-disabled engine."""
    make, params = KINDS[kind]
    staged = _engine()
    padded = Engine(hardware="tpu_v5e", device="cpu", staging=False)
    ref = ref_vortex.Engine(ref_vortex.EngineConfig(
        hardware="tpu_v5e", staging=False))
    rng = np.random.default_rng(7)
    for m in (1, 21, 32):
        args = make(rng, m)
        a = _to_torch(args)
        assert torch.equal(staged.dispatch(kind, *a, **params),
                           padded.dispatch(kind, *a, **params)), (kind, m)
        with ref_vortex.use(ref):
            ref.dispatch(kind, *(jnp.asarray(x) if isinstance(x, np.ndarray)
                                 else x for x in args), **params)
    d, rd = padded.stats()[kind], ref.stats()[kind]
    assert d["launches"] == 0 and d["stage_copies"] == 0
    for key in ("calls", "launches", "stage_copies", "unstage_copies",
                "padded_calls"):
        assert d[key] == rd[key], key


def test_staging_buffers_are_reused_and_capped_by_the_pool_cap():
    """Sequential unaligned calls in one bucket reuse ONE pooled buffer
    set, as the reference's do; ``staging_pool_cap`` bounds what each
    entry retains (0 retains nothing)."""
    rng = np.random.default_rng(8)
    b = rng.standard_normal((96, 80)).astype(np.float32)

    def a(m):
        return rng.standard_normal((m, 96)).astype(np.float32)

    for cap in (0, 2, 4):
        port, ref = _knob_engines(staging_pool_cap=cap)
        kern = port.op_kernel("gemm", _to_torch((a(8), b)), {})
        rkern = ref.op_kernel("gemm", (jnp.asarray(a(8)), jnp.asarray(b)), {})
        bucket = kern.select(257).padded_m
        assert bucket == rkern.select(257).padded_m

        def sets(k):
            return sum(len(e.pool.retained) for e in k._exec_cache.values())

        for m in (bucket - 1, bucket - 2):
            x = a(m)
            kern(*_to_torch((x, b)))
            rkern(jnp.asarray(x), jnp.asarray(b))
            assert sets(kern) == sets(rkern) == min(cap, 1)
        assert len(kern._exec_cache) == len(rkern._exec_cache)
        assert kern.dispatch_stats.stage_copies == \
            rkern.dispatch_stats.stage_copies == 2
        entry = next(iter(kern._exec_cache.values()))
        assert entry.pool.cap == cap
        # A burst of cap + 2 buffer sets in flight: the releases keep at
        # most ``cap`` of them, evicting the least recently used.
        need = {0: ((bucket, 96), torch.float32)}
        burst = [entry.pool.acquire(need, torch.device("cpu"))
                 for _ in range(cap + 2)]
        for bufs in burst:
            entry.pool.release(bufs, torch.device("cpu"))
        assert len(entry.pool.retained) == cap
        assert all(r is s for r, s in zip(entry.pool.retained, burst[2:]))
