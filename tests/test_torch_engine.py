"""The port's dispatch engine: masked-tail staging, counters, buckets.

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


KINDS = {
    "gemm": (_gemm_args, {}),
    "attention": (_attn_args, {"causal": True}),
    "decode_attention": (_decode_args, {}),
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


def test_engine_on_cpu_refuses_the_cuda_impl():
    with pytest.raises(ValueError):
        Engine(hardware="tpu_v5e", device="cpu", impl="cuda")
