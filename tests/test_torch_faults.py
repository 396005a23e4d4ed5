"""Deterministic fault injection and the kernel degradation ladder in the
port (mirrors tests/test_faults.py; DESIGN.md §11), on the CPU.

* The reference's cases, one for one: FaultPlan semantics, the ladder's
  retry, its ``impl="torch"`` rung, the rollback when the last rung fails
  too, persistence across a restart, quiet denylist I/O, and a silent
  ladder with no plan installed.
* Parity with the JAX package (``impl="xla"`` there, ``impl="torch"``
  here; the ``host_cpu`` and ``tpu_v5e`` lattices): under the same plan
  and the same seeded extents both engines fire the same occurrences,
  quarantine the same keys, count the same ``calls``, ``launches``,
  ``quarantined`` and ``fallbacks``, persist the same denylist entries
  per signature (file names differ: the fingerprints do), and agree
  within 1e-5 of the output's largest magnitude (float32: the two
  lowerings accumulate in different orders).  ``FaultPlan.random``
  draws the reference's spec.
* What only the port has: a kernel library that fails to build, and
  operands a wrapper refuses whatever the tile (``OperandError``: a
  stride, dtype, device or shape), propagate with nothing quarantined or
  persisted; operands on the card have no ``impl="torch"`` rung, so an
  exhausted ladder raises ``LadderExhaustedError`` with its quarantines
  rolled back (ROADMAP C10; on the CPU through a stubbed ``_on_card``,
  on the card in a ``cuda`` case); a forwarded call
  skips a quarantined candidate where the reference relaunches it
  (ROADMAP C9); the ladder inside a CUDA graph's warm-up and capture
  (the stub capture of tests/test_torch_graphs.py, whose replay fires no
  fault site, as a real replay does not); the scheduler isolating the
  rows of a step whose ladder raised.
* ``tools/chaos_torch.py --device cpu`` passes every gate for seeds 0-2.
"""
import contextlib
import dataclasses
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs.paper_gpt2 import SMOKE
from repro_torch.core import engine as engine_mod
from repro_torch.core.denylist import DenylistStore
from repro_torch.core.hardware import get_hardware
from repro_torch.core.workloads import GemmWorkload
from repro_torch.launch import graphs
from repro_torch.launch.graphs import StepCounters
from repro_torch.launch.scheduler import ContinuousScheduler
from repro_torch.launch.serve import Request, RequestError, VortexServer
from repro_torch.models.params import init_params
from repro_torch.runtime import faults
from repro_torch.vortex import Engine

ROOT = pathlib.Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(11)
HAMMER = {"aot_launch": range(1, 200), "precompile": range(1, 200)}
PARITY_TOL = 1e-5


def _arr(shape):
    return torch.from_numpy(RNG.normal(size=shape).astype(np.float32))


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "vortex-cache")
    monkeypatch.setenv("VORTEX_CACHE_DIR", d)
    return d


def _engine(hardware="host_cpu", **over):
    over.setdefault("denylist_persist", False)
    return Engine(hardware, device="cpu", empirical_levels=(), **over)


def _deny_files(d):
    return [f for f in os.listdir(d) if f.endswith(".deny.json")] \
        if os.path.isdir(d) else []


# ---------------------------------------------------------------------------
# FaultPlan semantics (the reference's cases)
# ---------------------------------------------------------------------------


def test_plan_fires_exact_occurrences():
    plan = faults.FaultPlan({"pool_lease": [2, 4]})
    fired = []
    for i in range(1, 6):
        try:
            plan.check("pool_lease")
        except faults.InjectedFault as exc:
            assert exc.site == "pool_lease" and exc.occurrence == i
            fired.append(i)
    assert fired == [2, 4]
    assert plan.fired == [("pool_lease", 2), ("pool_lease", 4)]
    assert plan.counts == {"pool_lease": 5}


def test_plan_counters_are_per_site():
    plan = faults.FaultPlan({"aot_launch": [1]})
    plan.check("precompile")  # other sites never trip this spec
    plan.check("scheduler_step")
    with pytest.raises(faults.InjectedFault):
        plan.check("aot_launch")
    assert plan.counts == {
        "precompile": 1, "scheduler_step": 1, "aot_launch": 1
    }


def test_plan_validates_sites_and_indices():
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.FaultPlan({"warp_drive": [1]})
    with pytest.raises(ValueError, match="1-based"):
        faults.FaultPlan({"pool_lease": [0]})


def test_random_plan_deterministic_and_never_empty():
    a = faults.FaultPlan.random(123)
    b = faults.FaultPlan.random(123)
    assert a.spec == b.spec
    assert a.spec != faults.FaultPlan.random(124).spec
    # rate=0 would draw nothing: occurrence 1 of the first site is forced.
    c = faults.FaultPlan.random(0, sites=("cache_io",), rate=0.0)
    assert c.spec == {"cache_io": frozenset([1])}


def test_installed_scopes_and_restores():
    assert faults.ACTIVE is None
    outer = faults.FaultPlan({"pool_lease": [1]})
    inner = faults.FaultPlan({"cache_io": [1]})
    with faults.installed(outer):
        assert faults.ACTIVE is outer
        with faults.installed(inner):
            assert faults.ACTIVE is inner
        assert faults.ACTIVE is outer
    assert faults.ACTIVE is None
    # ...even when the body raises.
    with pytest.raises(RuntimeError):
        with faults.installed(outer):
            raise RuntimeError("boom")
    assert faults.ACTIVE is None


# ---------------------------------------------------------------------------
# The degradation ladder (the reference's cases)
# ---------------------------------------------------------------------------


def test_launch_fault_retries_next_best_candidate():
    eng = _engine()
    x, w = _arr((33, 64)), _arr((64, 64))
    ref = eng.dispatch("gemm", x, w)  # warm, no plan

    with faults.installed(faults.FaultPlan({"aot_launch": [1]})):
        got = eng.dispatch("gemm", x, w)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-5)
    st = eng.stats()["gemm"]
    assert st["quarantined"] == 1
    assert st["fallbacks"] == 0  # the lattice retry sufficed


def test_hammered_lattice_falls_back_to_reference():
    eng = _engine()
    x, w = _arr((45, 64)), _arr((64, 64))
    ref = x @ w

    with faults.installed(faults.FaultPlan(HAMMER)):
        got = eng.dispatch("gemm", x, w)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-5)
    st = eng.stats()["gemm"]
    assert st["fallbacks"] == 1
    # Primary + max_kernel_retries re-selections all quarantined.
    assert st["quarantined"] == 1 + eng.config.max_kernel_retries
    kern = next(iter(eng.kernels().values()))
    assert any(k[0] == "__torch_fallback__" for k in kern._exec_cache)


def test_reference_failure_rolls_back_quarantines():
    """When even the impl="torch" rung fails, the inputs (not the
    candidates) are at fault: the original error propagates and nothing
    stays quarantined -- a user error never poisons the lattice."""
    eng = _engine()
    x, w = _arr((51, 64)), _arr((64, 64))
    eng.dispatch("gemm", x, w)  # warm
    kern = next(iter(eng.kernels().values()))

    def broken_fallback(m, args):
        raise RuntimeError("reference rung down too")

    kern._fallback_dispatch = broken_fallback
    try:
        with faults.installed(faults.FaultPlan(HAMMER)):
            with pytest.raises(RuntimeError, match="reference rung") as ei:
                eng.dispatch("gemm", x, w)
        # The candidate failure that started the walk rides along as the
        # explicit cause (raise ... from).
        assert isinstance(ei.value.__cause__, faults.InjectedFault)
    finally:
        del kern._fallback_dispatch  # the class's method again
    st = eng.stats()["gemm"]
    assert st["quarantined"] == 0  # rolled back
    assert not kern._quarantined
    # The kernel recovers completely once the fault clears.
    torch.testing.assert_close(eng.dispatch("gemm", x, w), x @ w,
                               rtol=2e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Denylist persistence across restarts (the reference's cases)
# ---------------------------------------------------------------------------


def test_quarantine_survives_restart_never_reattempted(cache_dir):
    eng = _engine(denylist_persist=True)
    x, w = _arr((39, 64)), _arr((64, 64))
    ref = x @ w
    with faults.installed(faults.FaultPlan(HAMMER)):
        eng.dispatch("gemm", x, w)
    kern = next(iter(eng.kernels().values()))
    quarantined = set(kern._quarantined)
    assert quarantined and eng.stats()["gemm"]["fallbacks"] == 1

    deny = _deny_files(cache_dir)
    assert len(deny) == 1
    blob = json.load(open(os.path.join(cache_dir, deny[0])))
    assert blob["version"] == 1
    assert set(*blob["kernels"].values()) == quarantined

    # Fresh engine, same fingerprint: the quarantine pre-seeds and the
    # known-bad candidates are NEVER re-attempted -- no plan installed,
    # yet zero quarantine events and zero fallbacks.
    eng2 = _engine(denylist_persist=True)
    got = eng2.dispatch("gemm", x, w)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-5)
    kern2 = next(iter(eng2.kernels().values()))
    assert kern2._quarantined == quarantined
    st2 = eng2.stats()["gemm"]
    assert st2["quarantined"] == 0 and st2["fallbacks"] == 0


def test_denylist_io_fault_is_quiet(cache_dir):
    """A cache_io fault during denylist persistence never reaches the
    dispatch path: the quarantine stays effective in memory."""
    eng = _engine(denylist_persist=True)
    x, w = _arr((29, 64)), _arr((64, 64))
    ref = eng.dispatch("gemm", x, w)
    # No denylist file exists yet, so the load at kernel build checked no
    # site; fail the store's two checks instead.
    with faults.installed(faults.FaultPlan({
        "aot_launch": [1], "cache_io": [1, 2],
    })):
        got = eng.dispatch("gemm", x, w)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-5)
    assert eng.stats()["gemm"]["quarantined"] == 1
    assert eng._denylist.counters["store_rejects"] == 1
    assert not _deny_files(cache_dir)


# ---------------------------------------------------------------------------
# Zero overhead with no plan (the reference's case)
# ---------------------------------------------------------------------------


def test_no_plan_is_bit_identical_and_ladder_silent():
    assert faults.ACTIVE is None
    eng = _engine()
    x, w = _arr((77, 64)), _arr((64, 64))
    a = eng.dispatch("gemm", x, w)
    b = eng.dispatch("gemm", x, w)
    assert torch.equal(a, b)  # bit-identical repeat
    st = eng.stats()["gemm"]
    assert st["fallbacks"] == 0 and st["quarantined"] == 0


def test_concurrent_walks_count_each_quarantine_once():
    """Threads walking the ladder on one kernel at once: every quarantined
    key is counted exactly once, and every call returns the right rows."""
    import sys
    import threading

    eng = _engine()
    w = _arr((64, 64))
    xs = [_arr((m, 64)) for m in (29, 45, 77, 101, 130, 200, 233, 260)]
    for x in xs:
        eng.dispatch("gemm", x, w)  # build the primary executables
    plan = faults.FaultPlan({"aot_launch": range(1, 400, 3),
                             "precompile": range(1, 400, 4)})
    errors, switch = [], sys.getswitchinterval()

    def worker(x):
        try:
            for _ in range(5):
                torch.testing.assert_close(eng.dispatch("gemm", x, w), x @ w,
                                           rtol=2e-4, atol=1e-4)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(x,)) for x in xs * 2]
    sys.setswitchinterval(1e-5)
    try:
        with faults.installed(plan):
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert plan.fired
    kern = next(iter(eng.kernels().values()))
    assert eng.stats()["gemm"]["quarantined"] == len(kern._quarantined) >= 1


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

PARITY_PLANS = {
    "mixed": {"precompile": [2, 5], "aot_launch": [1, 3, 4, 9]},
    "hammer": HAMMER,
    "retry_exhausted": {"aot_launch": [1, 2, 3]},
}
COUNTERS = ("calls", "launches", "quarantined", "fallbacks", "padded_calls",
            "aligned_calls", "unaligned_calls")


def _stream(seed=0, n=6, d=64):
    rng = np.random.default_rng(seed)
    ms = [int(m) for m in rng.integers(17, 300, size=n)]
    w = rng.normal(size=(d, d)).astype(np.float32)
    return [rng.normal(size=(m, d)).astype(np.float32) for m in ms], w


def _jax_engine(hardware, **over):
    from repro.vortex import Engine as JaxEngine

    over.setdefault("denylist_persist", False)
    return JaxEngine(hardware, empirical_levels=(), **over)


def _run_both(hardware, spec, xs, w, *, jax_over=None, torch_over=None):
    """The same stream through both engines under the same plan:
    (plan, outputs, engine) per package."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.runtime import faults as jfaults

    je = _jax_engine(hardware, **(jax_over or {}))
    te = _engine(hardware, **(torch_over or {}))
    jplan, tplan = jfaults.FaultPlan(spec), faults.FaultPlan(spec)
    with jfaults.installed(jplan):
        jo = [np.asarray(je.dispatch("gemm", jnp.asarray(x), jnp.asarray(w)))
              for x in xs]
    with faults.installed(tplan):
        to = [te.dispatch("gemm", torch.from_numpy(x), torch.from_numpy(w))
              .numpy() for x in xs]
    return (jplan, jo, je), (tplan, to, te)


def _assert_same_ladder(j, t):
    (jplan, jo, je), (tplan, to, te) = j, t
    assert tplan.fired == jplan.fired
    assert tplan.counts == jplan.counts
    jk, tk = (next(iter(e._kernels.values())) for e in (je, te))
    assert tk._sig_key == jk._sig_key
    assert tk._quarantined == jk._quarantined
    js, ts = je.stats()["gemm"], te.stats()["gemm"]
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    for a, b in zip(jo, to):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= PARITY_TOL * max(np.abs(a).max(), 1.0)


@pytest.mark.parametrize("hardware", ("host_cpu", "tpu_v5e"))
@pytest.mark.parametrize("plan", sorted(PARITY_PLANS))
def test_ladder_matches_the_jax_package(hardware, plan):
    xs, w = _stream()
    j, t = _run_both(hardware, PARITY_PLANS[plan], xs, w)
    _assert_same_ladder(j, t)
    assert t[2].stats()["gemm"]["quarantined"] >= 1


@pytest.mark.parametrize("hardware", ("host_cpu", "tpu_v5e"))
def test_rollback_matches_the_jax_package(hardware):
    """Both last rungs down: the same error chain, nothing quarantined,
    the same counters."""
    xs, w = _stream(1, n=1)
    jnp = pytest.importorskip("jax.numpy")
    from repro.runtime import faults as jfaults

    je, te = _jax_engine(hardware), _engine(hardware)
    x, wj, wt = xs[0], jnp.asarray(w), torch.from_numpy(w)
    je.dispatch("gemm", jnp.asarray(x), wj)
    te.dispatch("gemm", torch.from_numpy(x), wt)

    def down(m, args):
        raise RuntimeError("last rung down")

    for e in (je, te):
        next(iter(e._kernels.values()))._fallback_dispatch = down
    jplan, tplan = jfaults.FaultPlan(HAMMER), faults.FaultPlan(HAMMER)
    with jfaults.installed(jplan), pytest.raises(RuntimeError) as jerr:
        je.dispatch("gemm", jnp.asarray(x), wj)
    with faults.installed(tplan), pytest.raises(RuntimeError) as terr:
        te.dispatch("gemm", torch.from_numpy(x), wt)
    assert str(terr.value) == str(jerr.value) == "last rung down"
    assert type(terr.value.__cause__).__name__ == "InjectedFault"
    assert str(terr.value.__cause__) == str(jerr.value.__cause__)
    assert tplan.fired == jplan.fired
    for e in (je, te):
        kern = next(iter(e._kernels.values()))
        assert not kern._quarantined
        del kern._fallback_dispatch
    js, ts = je.stats()["gemm"], te.stats()["gemm"]
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}


@pytest.mark.parametrize("hardware", ("host_cpu", "tpu_v5e"))
def test_denylist_and_restart_match_the_jax_package(hardware, tmp_path):
    """The same entries per signature persist in both packages' denylist
    files, and a restarted engine of each serves the same stream with zero
    quarantine events."""
    xs, w = _stream(2)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    over = {"denylist_persist": True}
    j, t = _run_both(hardware, PARITY_PLANS["mixed"], xs, w,
                     jax_over={**over, "calibration_cache_dir": jdir},
                     torch_over={**over, "calibration_cache_dir": tdir})
    _assert_same_ladder(j, t)
    (jf,), (tf,) = _deny_files(jdir), _deny_files(tdir)
    assert jf != tf  # different fingerprints, the same entries
    jblob = json.load(open(os.path.join(jdir, jf)))
    tblob = json.load(open(os.path.join(tdir, tf)))
    assert tblob == jblob and tblob["kernels"]
    j2, t2 = _run_both(hardware, {}, xs, w,
                       jax_over={**over, "calibration_cache_dir": jdir},
                       torch_over={**over, "calibration_cache_dir": tdir})
    _assert_same_ladder(j2, t2)
    assert t2[2].stats()["gemm"]["quarantined"] == 0
    assert t2[2].stats()["gemm"]["fallbacks"] == 0
    assert next(iter(t2[2]._kernels.values()))._quarantined == \
        next(iter(t[2]._kernels.values()))._quarantined


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_random_plan_is_the_references(seed):
    from repro.runtime import faults as jfaults

    assert faults.SITES == jfaults.SITES
    assert faults.FaultPlan.random(seed).spec == \
        jfaults.FaultPlan.random(seed).spec


# ---------------------------------------------------------------------------
# What only the port has
# ---------------------------------------------------------------------------


def _cuda_kernel(store=None):
    """A gemm kernel with impl="cuda" whose executables are built (not
    launched) on the CPU: enough to reach ``kernels.build.library()``."""
    return engine_mod.VortexKernel(
        get_hardware("tpu_v5e"), GemmWorkload(M=None, N=64, K=64),
        impl="cuda", empirical_levels=(), denylist=store)


@pytest.mark.parametrize("plan", ({}, {"precompile": [1]}))
def test_a_failed_library_build_propagates_unquarantined(plan, tmp_path,
                                                         monkeypatch):
    """nvcc missing or failing is no candidate's fault: the error leaves
    the ladder with nothing quarantined or persisted, whether the first
    rung or a retry (after an injected fault) builds the library."""
    from repro_torch.kernels import build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "library", no_nvcc)
    store = DenylistStore(get_hardware("tpu_v5e"), ("mxu",), "cuda", "cpu",
                          cache_dir=str(tmp_path))
    kern = _cuda_kernel(store)
    with faults.installed(faults.FaultPlan(plan)):
        with pytest.raises(engine_mod.KernelLibraryError,
                           match="nvcc not found"):
            kern(_arr((45, 64)), _arr((64, 64)))
    assert kern.dispatch_stats.quarantined == 0
    assert kern.dispatch_stats.fallbacks == 0
    assert not kern._quarantined
    assert store.counters["saves"] == 0 and not os.listdir(tmp_path)


def _strided_refusing_gemm(monkeypatch):
    """Make gemm executables refuse strided operands as the CUDA wrapper
    does (kernels/gemm.py), on the CPU."""
    from repro_torch.kernels.gemm import OperandError

    real = GemmWorkload.build_executable

    def build_executable(self, sel, *, impl):
        fn = real(self, sel, impl=impl)

        def strict(*args):
            if not all(a.is_contiguous() for a in args
                       if isinstance(a, torch.Tensor)):
                raise OperandError("vortex_gemm: operands must be contiguous")
            return fn(*args)

        return strict

    monkeypatch.setattr(GemmWorkload, "build_executable", build_executable)


@pytest.mark.parametrize("m", (45, 64))  # unaligned (A staged), aligned
def test_a_refused_operand_propagates_unquarantined(m, cache_dir,
                                                    monkeypatch):
    """A strided weight reaches every candidate alike: the wrapper's
    OperandError leaves the ladder at once, with no retry, no quarantine,
    no fallback and no denylist file."""
    from repro_torch.kernels.gemm import OperandError

    _strided_refusing_gemm(monkeypatch)
    eng = _engine("tpu_v5e", denylist_persist=True)
    x, w = _arr((m, 64)), _arr((64, 64))
    torch.testing.assert_close(eng.dispatch("gemm", x, w), x @ w,
                               rtol=2e-4, atol=1e-5)
    plan = faults.FaultPlan({})
    with faults.installed(plan):
        with pytest.raises(OperandError, match="contiguous"):
            eng.dispatch("gemm", x, w.t())
    assert plan.counts.get("aot_launch") == 1  # one rung tried, no retry
    kern = next(iter(eng.kernels().values()))
    st = eng.stats()["gemm"]
    assert st["quarantined"] == 0 and st["fallbacks"] == 0
    assert not kern._quarantined and not _deny_files(cache_dir)


@pytest.mark.parametrize("case", ("gemm", "grouped_gemm", "attention"))
def test_wrappers_refuse_operands_with_an_operand_error(case):
    """The wrappers' operand checks raise OperandError on every device
    where they run first (shapes), and it is still a ValueError and a
    TypeError for callers that caught those."""
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.gemm import OperandError, vortex_gemm
    from repro_torch.kernels.grouped_gemm import vortex_grouped_gemm

    call = {
        "gemm": lambda: vortex_gemm(_arr((4, 8)), _arr((9, 4))),
        "grouped_gemm": lambda: vortex_grouped_gemm(
            _arr((2, 4, 8)), _arr((1, 9, 4)), [4, 4]),
        "attention": lambda: flash_attention(
            _arr((1, 3, 4, 8)), _arr((1, 2, 4, 8)), _arr((1, 2, 4, 8)),
            block_q=4, block_k=4),
    }[case]
    with pytest.raises(OperandError) as ei:
        call()
    assert isinstance(ei.value, ValueError) and isinstance(ei.value,
                                                           TypeError)


def test_an_exhausted_ladder_on_the_card_raises_and_rolls_back(
        cache_dir, monkeypatch):
    """ROADMAP C10: operands on the card never reach a plain version.
    The ladder tries 1 + max_kernel_retries hand-written candidates, then
    raises LadderExhaustedError from the last failure, with this call's
    quarantines rolled back and nothing persisted; the call succeeds
    once the fault clears.  (``_on_card`` stubbed: the operands here lie
    on the CPU.)"""
    monkeypatch.setattr(engine_mod, "_on_card", lambda args: True)
    eng = _engine(denylist_persist=True)
    x, w = _arr((45, 64)), _arr((64, 64))
    plan = faults.FaultPlan(HAMMER)
    with faults.installed(plan):
        with pytest.raises(engine_mod.LadderExhaustedError) as ei:
            eng.dispatch("gemm", x, w)
    assert isinstance(ei.value.__cause__, faults.InjectedFault)
    assert len(plan.fired) == 1 + eng.config.max_kernel_retries
    kern = next(iter(eng.kernels().values()))
    st = eng.stats()["gemm"]
    assert st["quarantined"] == 0 and st["fallbacks"] == 0
    assert not kern._quarantined and not _deny_files(cache_dir)
    assert not any(k[0] == "__torch_fallback__" for k in kern._exec_cache)
    torch.testing.assert_close(eng.dispatch("gemm", x, w), x @ w,
                               rtol=2e-4, atol=1e-5)


@pytest.mark.cuda
def test_an_exhausted_ladder_raises_on_the_card(tmp_path):
    """The same on the card, through the hand-written kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")
    eng = Engine(calibration_cache_dir=str(tmp_path))
    x = torch.randn(100, 768, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(768, 768, device="cuda", dtype=torch.bfloat16)
    with faults.installed(faults.FaultPlan(HAMMER)):
        with pytest.raises(engine_mod.LadderExhaustedError):
            eng.dispatch("gemm", x, w)
    st = eng.stats()["gemm"]
    assert st["quarantined"] == 0 and st["fallbacks"] == 0
    assert not _deny_files(str(tmp_path))
    ref = x.float() @ w.float()
    got = eng.dispatch("gemm", x, w).float()
    assert float((got - ref).abs().max() / ref.abs().max()) <= 2.0 ** -7


def _spy_selections(kern, log):
    real = kern._entry_for

    def entry_for(sel, args=()):
        log.append(kern._qkey(sel))
        return real(sel, args)

    kern._entry_for = entry_for


def test_forwarded_call_skips_a_quarantined_candidate_c9():
    """ROADMAP C9: the reference's ``_call_forwarded`` selects with
    ``selector.select`` and relaunches a quarantined candidate (after a
    restart, a denylisted one); the port's selects with
    ``_select_healthy``."""
    jnp = pytest.importorskip("jax.numpy")

    x, w = _arr((45, 64)), _arr((64, 64))
    picked = {}
    for name, eng, conv in (
        ("torch", _engine("tpu_v5e"), lambda a: a),
        ("jax", _jax_engine("tpu_v5e"), lambda a: jnp.asarray(a.numpy())),
    ):
        h = eng.dispatch("gemm", conv(x), conv(w), lazy=True)
        assert type(h).__name__ == "LazyBucket" and not h.is_aligned
        kern = next(iter(eng._kernels.values()))
        bad = kern.selector.select(h.padded_extent)
        kern._quarantine(bad)
        log = []
        _spy_selections(kern, log)
        out = eng.dispatch("gemm", h, conv(w))
        assert kern.dispatch_stats.realize_slices == 0  # forwarded
        np.testing.assert_allclose(np.asarray(out), (x @ w @ w).numpy(),
                                   rtol=1e-4, atol=1e-4)
        picked[name] = (log[-1], kern._qkey(bad))
    assert picked["torch"][0] != picked["torch"][1]
    assert picked["jax"][0] == picked["jax"][1]  # the reference's C9


# -- the ladder inside a CUDA graph's warm-up and capture (stub capture) ----

CFG = dataclasses.replace(SMOKE, dtype="float32")


class _StubGraph:
    """A CUDA graph's contract on the CPU: ``replay`` recomputes the
    captured step into the static outputs, moves no host counter and, as
    a replay is not an engine launch, fires no fault site."""

    def __init__(self, fn, outputs, counters):
        self.fn, self.outputs, self.counters = fn, outputs, counters

    def replay(self):
        before = self.counters.read()
        with faults.installed(None):
            out = self.fn()
        self.counters.add(StepCounters.diff(before, self.counters.read()),
                          sign=-1)
        for static, new in zip(self.outputs, out):
            static.copy_(new)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _servers(params, monkeypatch, on_capture=None):
    """A graphed server and an eager one on ONE engine (the same
    quarantines, so the same selections), and the stub capture."""
    eng = Engine("tpu_v5e", device="cpu", backends=("mxu",),
                 denylist_persist=False)
    srv = VortexServer(CFG, max_cache=256, params=params, engine=eng,
                       graphs=True)
    eager = VortexServer(CFG, max_cache=256, params=params, engine=eng,
                         graphs=False)
    counters = StepCounters(eng)

    def capture(fn, pool, stream):
        with on_capture() if on_capture else contextlib.nullcontext():
            out = fn()
        return _StubGraph(fn, out, counters), out

    monkeypatch.setattr(graphs, "capture_graph", capture)
    return srv, eager, eng


def _decode_setup(srv, eager, rng):
    b, s = 2, 40
    tok, cache, _ = srv.prefill(
        rng.integers(0, CFG.vocab, (b, s)).astype(np.int64))
    copy = {k: {n: leaf.clone() for n, leaf in e.items()}
            for k, e in cache.items()}
    eager.adopt_cache(copy)
    return tok[:, None], s, cache, copy


def _step_launches(eager, copy, t, pos):
    """aot_launch checks of one eager decode step (one per engine call)."""
    probe = {k: {n: leaf.clone() for n, leaf in e.items()}
             for k, e in copy.items()}
    count = faults.FaultPlan({})
    with faults.installed(count):
        eager._step(probe, t, pos)
    return count.counts["aot_launch"]


def _ladder(eng):
    st = eng.stats()["decode_attention"]
    return st["quarantined"], st["fallbacks"]


def test_warmup_quarantine_counts_once_and_replays_add_none(params,
                                                            monkeypatch):
    srv, eager, eng = _servers(params, monkeypatch)
    t, pos, cache, copy = _decode_setup(srv, eager, np.random.default_rng(1))
    n = _step_launches(eager, copy, t, pos)
    plan = faults.FaultPlan({"aot_launch": [1]})  # the warm-up's first
    with faults.installed(plan):
        logits = [srv._decode(cache, t, pos + i, srv._decode_seen)
                  for i in range(4)]
        seen = plan.counts["aot_launch"]
    assert plan.fired == [("aot_launch", 1)]
    assert seen == 2 * n + 1  # warm-up (one retry) and capture only
    assert srv.stats["decode_graph_captures"] == 1
    assert srv.stats["decode_graph_replays"] == 4
    assert _ladder(eng) == (1, 0)  # counted once, not rolled back
    g = srv.graphs.get(srv.graphs.keys()[-1])
    assert not StepCounters.ladder_moved(g.delta)
    want = [eager._decode(copy, t, pos + i, eager._decode_seen)
            for i in range(4)]
    for a, b in zip(logits, want):
        assert torch.equal(a, b)
    srv.release_cache(cache)
    eager.release_cache(copy)


def test_fault_in_the_capture_takes_one_recapture(params, monkeypatch):
    srv, eager, eng = _servers(params, monkeypatch)
    t, pos, cache, copy = _decode_setup(srv, eager, np.random.default_rng(2))
    n = _step_launches(eager, copy, t, pos)
    plan = faults.FaultPlan({"aot_launch": [n + 1]})  # the capture's first
    with faults.installed(plan):
        got = srv._decode(cache, t, pos, srv._decode_seen)
        seen = plan.counts["aot_launch"]
        got2 = srv._decode(cache, t, pos + 1, srv._decode_seen)
        assert plan.counts["aot_launch"] == seen  # a replay fires no site
    assert plan.fired == [("aot_launch", n + 1)]
    # warm-up, the faulted capture (one retry), warm-up, capture.
    assert seen == 4 * n + 1
    assert srv.stats["decode_graph_captures"] == 1
    assert _ladder(eng) == (1, 0)
    assert torch.equal(got, eager._decode(copy, t, pos, eager._decode_seen))
    assert torch.equal(got2,
                       eager._decode(copy, t, pos + 1, eager._decode_seen))
    srv.release_cache(cache)
    eager.release_cache(copy)


def test_a_ladder_unsettled_in_two_captures_raises(params, monkeypatch):
    """A fault in every capture: no settled candidate to capture, so the
    step raises (the graph of a failed rung is never kept)."""
    hammer = faults.FaultPlan({"aot_launch": [1]})
    armed = []  # after the prefill's capture

    def each_capture():
        if not armed:
            return contextlib.nullcontext()
        hammer._seen.clear()  # the first launch of EVERY capture fails
        return faults.installed(hammer)

    srv, eager, eng = _servers(params, monkeypatch, each_capture)
    t, pos, cache, copy = _decode_setup(srv, eager, np.random.default_rng(3))
    armed.append(1)
    with pytest.raises(RuntimeError, match="two captures"):
        srv._decode(cache, t, pos, srv._decode_seen)
    assert hammer.fired == [("aot_launch", 1)] * 2
    assert srv.graphs.keys() == []
    assert _ladder(eng) == (2, 0)
    srv.release_cache(cache)
    eager.release_cache(copy)


def test_scheduler_isolates_rows_of_a_step_whose_ladder_raised(params,
                                                               monkeypatch):
    """Every candidate fails inside the decode capture and the impl="torch"
    rung cannot be captured: the ladder rolls back and raises, the capture
    raises, and the scheduler fails exactly the rows that shared the step;
    its next request decodes normally."""
    hammer = faults.FaultPlan({"aot_launch": range(1, 10_000)})
    in_decode = []

    def decode_only():
        if not in_decode:
            return contextlib.nullcontext()
        for k in eng.kernels().values():
            def uncapturable(m, args):
                raise RuntimeError("operation not permitted when stream "
                                   "is capturing")
            k._fallback_dispatch = uncapturable
        return faults.installed(hammer)

    srv, eager, eng = _servers(params, monkeypatch, decode_only)
    real = srv.graphs._capture

    def decode_capture(*args):
        in_decode.append(1)
        try:
            return real(*args)
        finally:
            in_decode.clear()
            for k in eng.kernels().values():
                k.__dict__.pop("_fallback_dispatch", None)

    srv.graphs._capture = decode_capture
    rng = np.random.default_rng(4)
    reqs = [Request(tokens=rng.integers(0, CFG.vocab, (1, s)).astype(
        np.int64), max_new=4) for s in (20, 33)]
    sched = ContinuousScheduler(srv, batch_rows=4)
    rids = [sched.submit(r) for r in reqs]
    res = sched.drain()
    for rid in rids:
        assert isinstance(res[rid], RequestError)
        assert res[rid].stage == "decode"
    assert hammer.fired  # the ladder walked inside the capture
    assert _ladder(eng) == (0, 0)  # rolled back: nothing learned
    srv.graphs._capture = real
    rid = sched.submit(reqs[0])
    out = sched.drain()[rid]
    assert np.array_equal(out, eager.generate(reqs[0]))
    sched.close()
    assert srv.kv_pool.stats()["leases_active"] == 0


# ---------------------------------------------------------------------------
# tools/chaos_torch.py on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chaos_torch():
    spec = importlib.util.spec_from_file_location(
        "chaos_torch", ROOT / "tools" / "chaos_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_chaos_torch_passes_every_gate_on_the_cpu(chaos_torch, seed,
                                                  cache_dir):
    assert chaos_torch.run(seed, "cpu") == []
