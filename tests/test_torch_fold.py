"""Unaligned engine calls that launch on the caller's own operands.

On the card an unaligned dispatch of a workload that ``stages_in_launch``
makes one launch of the bucket's kernel on the operands at their true
extents: no staging copy, no pool checkout, no output slice
(core/engine.py ``_launch_folds``).  The card is not here, so these tests
force that branch on the CPU's plain executables by patching the engine's
branch predicate and nothing else, and check, for every kind at an
unaligned extent:

* the executable receives each operand at its own shape;
* no staging set is checked out;
* ``stage_copies + folded_stages`` and ``unstage_copies + folded_unstages``
  equal the JAX package's ``stage_copies`` and ``unstage_copies`` for the
  same calls, and the other counters are equal;
* the output matches the staged path's within 1e-5 of the output scale
  (the plain versions run the product at another extent, and aten may sum
  in another order there).

The decode kernel's split count must come from the bucket, not from the
cache it is handed: :func:`decode_geometry` is the rule, and the decode
executable passes its bucket to the wrapper.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro import vortex as ref_vortex  # noqa: E402

from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core.workloads import DecodeAttentionWorkload  # noqa: E402
from repro_torch.kernels import attention as attention_mod  # noqa: E402
from repro_torch.kernels.attention import decode_geometry  # noqa: E402
from repro_torch.vortex import Engine  # noqa: E402

TOL = 1e-5  # of the output scale


def _gemm(rng, m):
    return (rng.standard_normal((m, 64)).astype(np.float32),
            rng.standard_normal((64, 48)).astype(np.float32))


def _attention(rng, m):
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((2, 4, m, 16), (2, 2, m, 16), (2, 2, m, 16)))


def _decode(rng, m):
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, 4, 1, 16), (2, 2, m, 16), (2, 2, m, 16)))
    return q, k, v, max(m - 3, 1)


def _decode_rows(rng, m):
    q, k, v, _ = _decode(rng, m)
    return q, k, v, np.array([m, max(m // 2, 1)], np.int32)


def _grouped(rng, m):
    x = rng.standard_normal((4, m, 16)).astype(np.float32)
    counts = np.array([0, m // 2, m, m], np.int32)
    w = rng.standard_normal((2, 16, 12)).astype(np.float32)
    return x, w, counts


def _conv(rng, m):
    return (rng.standard_normal((1, m + 2, 3, 4)).astype(np.float32),
            rng.standard_normal((3, 3, 4, 8)).astype(np.float32))


# kind -> (dispatch kind, args maker, params, dynamic view positions).
CASES = {
    "gemm": ("gemm", _gemm, {}, (0,)),
    "attention": ("attention", _attention, {"causal": True}, (0, 1, 2)),
    "decode_attention": ("decode_attention", _decode, {}, (1, 2)),
    "decode_attention_per_row": ("decode_attention", _decode_rows, {},
                                 (1, 2)),
    "grouped_gemm": ("grouped_gemm", _grouped, {}, (0,)),
    "conv2d": ("conv2d", _conv, {}, (0,)),
}

COUNTERS = ("calls", "launches", "aligned_calls", "unaligned_calls",
            "padded_calls")


def _torch(args):
    return tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in args)


def _jax(args):
    return tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in args)


@pytest.fixture
def folding(monkeypatch):
    """The engine's branch predicate, forced to fold on the CPU."""
    monkeypatch.setattr(
        engine_mod, "_launch_folds",
        lambda impl, wl, view, unaligned: wl.stages_in_launch)


def _unaligned_extent(kern, kind):
    """An extent one row below a bucket boundary (in both the query and
    the key bucket for prefill attention)."""
    for m in range(300, 4, -1):
        sel = kern.select(m)
        if kind == "attention":
            if sel.bucket[0] != m and sel.bucket[2] != m:
                return m
        elif kern.workload.dynamic_bucket(sel) == m + 1:
            return m
    raise AssertionError(f"{kind}: no extent one row off a bucket")


@pytest.mark.parametrize("case", list(CASES))
def test_unaligned_call_launches_on_the_callers_operands(case, folding):
    kind, make, params, dyn = CASES[case]
    rng = np.random.default_rng(31)
    eng = Engine(hardware="tpu_v5e", device="cpu")
    staged = Engine(hardware="tpu_v5e", device="cpu")
    kern = eng.op_kernel(kind, _torch(make(rng, 8)), params)
    m = _unaligned_extent(kern, kind)
    args = make(rng, m)
    view = kern.workload.stage_view(*_torch(args))
    out = eng.dispatch(kind, *_torch(args), **params)  # builds the entry
    seen = []
    for entry in kern._exec_cache.values():
        def record(*xs, _fn=entry.fn):
            seen.append(tuple(tuple(x.shape) for x in xs
                              if isinstance(x, torch.Tensor)))
            return _fn(*xs)
        entry.fn = record
    again = eng.dispatch(kind, *_torch(args), **params)
    want = [tuple(x.shape) for x in view if isinstance(x, torch.Tensor)]
    assert seen == [tuple(want)], (case, seen, want)
    shapes = kern.workload.staged_shapes(kern.select(m), *view)
    assert all(tuple(view[i].shape) != shapes[i] for i in dyn), case
    assert sum(e.pool.allocs for e in kern._exec_cache.values()) == 0
    assert kern.staging_sets() == []
    assert torch.equal(out, again)

    # The staged path (the predicate restored for this engine alone is the
    # CPU's own: it stages into pool buffers).
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod, "_launch_folds",
                   lambda impl, wl, view, unaligned: False)
        ref_out = staged.dispatch(kind, *_torch(args), **params)
        padded = staged.op_kernel(kind, _torch(args), params).call_padded(
            *_torch(args))
    assert out.shape == ref_out.shape == padded.shape, case
    scale = max(float(ref_out.abs().max()), 1.0)
    assert float((out - ref_out).abs().max()) <= TOL * scale, case
    assert float((out - padded).abs().max()) <= TOL * scale, case

    d = eng.stats()[kind]
    ref = ref_vortex.Engine(ref_vortex.EngineConfig(hardware="tpu_v5e"))
    with ref_vortex.use(ref):
        for _ in range(2):
            ref.dispatch(kind, *_jax(args), **params)
    rd = ref.stats()[kind]
    assert d["stage_copies"] == d["unstage_copies"] == 0, case
    assert d["folded_stages"] == 2 * len(dyn), case
    assert d["stage_copies"] + d["folded_stages"] == rd["stage_copies"]
    assert d["unstage_copies"] + d["folded_unstages"] \
        == rd["unstage_copies"], case
    for key in COUNTERS:
        assert d[key] == rd[key], (case, key)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref.dispatch(kind, *_jax(args), **params)),
        rtol=0, atol=TOL * scale)


def test_lazy_output_and_the_cpu_keep_staging(folding):
    """A lazy output is bucket-shaped, so it keeps the staging copy even
    where the launch folds; the unpatched predicate folds nothing on the
    CPU and nothing for the plain executables."""
    rng = np.random.default_rng(32)
    eng = Engine(hardware="tpu_v5e", device="cpu")
    a, b = _torch(_gemm(rng, 8))
    kern = eng.op_kernel("gemm", (a, b), {})
    m = _unaligned_extent(kern, "gemm")
    a = torch.from_numpy(rng.standard_normal((m, 64)).astype(np.float32))
    h = kern(a, b, lazy=True)
    assert isinstance(h, engine_mod.LazyBucket) and not h.is_aligned
    st = kern.dispatch_stats
    assert (st.stage_copies, st.folded_stages, st.unstage_copies,
            st.folded_unstages) == (1, 0, 0, 0)
    assert sum(e.pool.allocs for e in kern._exec_cache.values()) == 1
    full = kern(a, b)
    scale = max(float(full.abs().max()), 1.0)
    assert float((h.realize() - full).abs().max()) <= TOL * scale
    assert st.folded_stages == 1 and st.folded_unstages == 1


def test_the_fold_predicate_needs_the_kernels_on_the_card():
    from repro_torch.core.workloads import GemmWorkload, Workload

    wl = GemmWorkload(M=None, N=8, K=8)
    view = (torch.zeros(3, 8), torch.zeros(8, 8))
    assert wl.stages_in_launch and not Workload.stages_in_launch
    for impl in ("cuda", "torch"):
        assert not engine_mod._launch_folds(impl, wl, view, [0])


def test_decode_split_rule_takes_the_bucket_extent(monkeypatch):
    """The decode executable hands the wrapper its bucket, and the split
    geometry at the cache's true extent with that bucket is the
    bucket-shaped call's.  The rule reads the bucket, not the cache: a
    cache blocks short of its bucket would otherwise split (and merge)
    differently."""
    calls = []

    def recorder(q, k, v, kv_len=None, q_offset=None, **kw):
        calls.append((tuple(k.shape), kw))
        return attention_mod.flash_attention_plain(
            q, k, v, kv_len, q_offset, causal=kw["causal"],
            window=kw["window"], softcap=kw["softcap"])

    monkeypatch.setattr(attention_mod, "flash_attention", recorder)
    # The H100's lattice: a kv bucket there holds several key blocks.
    eng = Engine(hardware="h100_sxm", device="cpu", empirical_levels=())
    rng = np.random.default_rng(33)
    q, k, v, _ = _torch(_decode(rng, 8))
    kern = eng.op_kernel("decode_attention", (q, k, v, 5), {})
    wl = kern.workload
    assert isinstance(wl, DecodeAttentionWorkload)
    s = _unaligned_extent(kern, "decode_attention")
    sel = kern.select(s)
    pkv, k1 = sel.bucket[2], sel.strategy.l1[2]
    assert pkv // k1 > 1, (s, sel)
    fn = wl.build_executable(sel, impl="cuda")
    q, k, v, _ = _torch(_decode(rng, s))
    rows = torch.tensor([s, s // 2], dtype=torch.int32)
    out = fn(q, k, v, rows)
    (shape, kw), = calls
    assert shape[2] == s and kw["bucket"] == (1, pkv) and kw["block_k"] == k1
    want = attention_mod.flash_attention_plain(
        q, k, v, rows, rows - 1, causal=False)
    assert torch.allclose(out, want, rtol=0, atol=TOL)
    info = torch.stack([rows, rows - 1])
    for sms in (1, 4, 16, 66, 132):
        assert decode_geometry(4, info, s, k1, sms, kw["bucket"][1]) \
            == decode_geometry(4, info, pkv, k1, sms), sms
        # One number for kv_len: the keys it leaves, whatever the cache.
        assert decode_geometry(4, s - 9, s, k1, sms, pkv) \
            == decode_geometry(4, s - 9, pkv, k1, sms), sms
    # A bucket blocks past the cache: the rule follows the bucket.
    assert decode_geometry(4, info, 100, 16, 132, 256) \
        == decode_geometry(4, info, 256, 16, 132) == (16, 16)
    assert decode_geometry(4, info, 100, 16, 132) == (16, 7)


def test_prefill_executable_passes_its_bucket_and_the_form_follows_it(
        monkeypatch):
    """The prefill executable hands the wrapper its (query, key) bucket,
    and the wrapper takes the form from it: one query row at block_q 1 is
    the decode form only when the bucket says so."""
    calls = []

    def recorder(q, k, v, kv_len=None, q_offset=None, **kw):
        calls.append(kw)
        return attention_mod.flash_attention_plain(
            q, k, v, kv_len, q_offset, causal=kw["causal"])

    monkeypatch.setattr(attention_mod, "flash_attention", recorder)
    eng = Engine(hardware="tpu_v5e", device="cpu")
    rng = np.random.default_rng(34)
    args = _torch(_attention(rng, 8))
    kern = eng.op_kernel("attention", args, {"causal": True})
    m = _unaligned_extent(kern, "attention")
    sel = kern.select(m)
    fn = kern.workload.build_executable(sel, impl="cuda")
    q, k, v = _torch(_attention(rng, m))
    fn(q, k, v, m)
    assert calls[0]["bucket"] == (sel.bucket[0], sel.bucket[2])

    monkeypatch.undo()
    q1, k1, v1 = (t[:, :, :1].contiguous() for t in (q, k, v))
    kw = {"block_q": 1, "block_k": 16, "backend": "tensor_core"}
    attention_mod.flash_attention(q1, k1, v1, bucket=(1, 16), **kw)
    with pytest.raises(ValueError, match="multiple of wgmma"):
        attention_mod.flash_attention(q1, k1, v1, bucket=(64, 16), **kw)
