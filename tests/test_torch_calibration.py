"""Background calibration in the port (core/calibrate.py, the selector's
calibration hooks, launch/calibration.py), held against the JAX package.

Mirrors tests/test_calibration.py case for case on the CPU with
``impl="torch"`` (its timing cases live in tests/test_torch_timing.py):

  * the hooks stay off-path exact: ``cost_scale=None`` / ``pinned=None``
    build bit-identical tables, and an engine with ``calibration="off"``
    (the default) never constructs a calibrator;
  * ``cost_scale`` re-ranks consistently with the scaled argmin and
    ``pinned`` overrides exactly the containing breakpoint interval;
  * the atomic swap survives concurrent dispatch;
  * persistence: fingerprint-keyed roundtrip with zero re-measurements,
    stale fingerprints, lattices and truncated files rejected;
  * injected I/O and measurement faults are counted, never raised;
  * the continuous scheduler donates idle slices only.

Against the JAX package, on the reference's hardware specs (``host_cpu``
and ``tpu_v5e``) for gemm, conv2d and the grouped GEMM, fully analytical:
the selector's calibration surface agrees (costs to rel 1e-12, rankings,
candidate selections, ``select_excluding`` and calibrated tables
identical), and both calibrators, fed the same synthetic measurements
through their ``interleaved_minima``, reach the same mode, coefficients,
residual, pins, installed table and report.

Port-only: measurements run in the served dtype (ROADMAP C5), the grouped
GEMM's example counts are full (C6), no measurement runs during a graph
capture, a daemon slice never overlaps a capture, and the fingerprint
follows the kernel sources.  One ``cuda`` case calibrates a bf16 gemm on
the card.
"""
import bisect
import dataclasses
import functools
import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.core import calibrate
from repro_torch.core.calibrate import (
    Calibrator,
    calibration_cache_dir,
    fingerprint_key,
    hardware_fingerprint,
    lattice_checksum,
)
from repro_torch.core.selection_table import (
    build_selection_table,
    merge_breakpoints,
)
from repro_torch.core.workloads import GroupedGemmWorkload
from repro_torch.launch import calibration as launch_calibration
from repro_torch.launch import graphs
from repro_torch.runtime import faults
from repro_torch.vortex import Engine, EngineConfig

RNG = np.random.default_rng(7)


def _arr(*shape, dtype=torch.float32):
    return torch.from_numpy(RNG.normal(size=shape).astype(np.float32)).to(
        dtype)


SMALL = dict(
    m_max=128, max_buckets=2, min_rounds=2, max_rounds=3, patience=1,
    top_k=2,
)
SMOKE = launch_calibration.SMOKE_POLICY  # the reference CLI's --smoke plan


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "vortex-cache")
    monkeypatch.setenv("VORTEX_CACHE_DIR", d)
    return d


def gemm_engine(**over) -> Engine:
    eng = Engine("host_cpu", device="cpu", empirical_levels=(), **over)
    eng.dispatch("gemm", _arr(33, 64), _arr(64, 64))
    return eng


def only_kernel(eng):
    (kern,) = eng.kernels().values()
    return kern


def calibrated(eng: Engine) -> Calibrator:
    cal = eng.calibrator
    cal.policy = dataclasses.replace(cal.policy, **SMALL)
    cal.run()
    return cal


# ---------------------------------------------------------------------------
# Parity with the JAX package: the selector's calibration surface and the
# calibrator's decisions on the same measurements
# ---------------------------------------------------------------------------

HWS = ("host_cpu", "tpu_v5e")


@functools.lru_cache(maxsize=None)
def _ref():
    """The JAX package's modules the parity tests hold the port against
    (imported on first use: the card's machine has no JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import calibrate as ref_calibrate
    from repro.core.selection_table import build_selection_table
    from repro.vortex import Engine as RefEngine

    return types.SimpleNamespace(jax=jax, jnp=jnp, calibrate=ref_calibrate,
                                 build_table=build_selection_table,
                                 Engine=RefEngine)


def _gemm_args(rng):
    return rng.normal(size=(33, 64)), rng.normal(size=(64, 64))


def _conv_args(rng):
    return rng.normal(size=(2, 10, 10, 4)), rng.normal(size=(3, 3, 4, 8))


def _grouped_args(rng):
    counts = np.asarray([5, 0, 3, 1, 5, 2, 4, 5], np.int32)
    return (rng.normal(size=(8, 5, 32)), rng.normal(size=(4, 32, 16)),
            counts)


KINDS = {"gemm": _gemm_args, "conv2d": _conv_args,
         "grouped_gemm": _grouped_args}


def _pair(hw: str, kind: str, **over):
    """(port engine, reference engine), each having dispatched the same
    call of ``kind`` once, fully analytical."""
    args = KINDS[kind](np.random.default_rng(3))
    port = Engine(hw, device="cpu", empirical_levels=(), **over)
    port.dispatch(kind, *(torch.from_numpy(a) if a.dtype == np.int32
                          else torch.from_numpy(a.astype(np.float32))
                          for a in args))
    R = _ref()
    ref = R.Engine(hw, empirical_levels=(), **over)
    ref.dispatch(kind, *(a if a.dtype == np.int32
                         else R.jnp.asarray(a, R.jnp.float32) for a in args))
    (rk,) = ref._kernels.values()
    return only_kernel(port), rk


@functools.lru_cache(maxsize=None)
def _analytical_pair(hw: str, kind: str):
    """One :func:`_pair` per (hw, kind) shared by the parity tests; a test
    that installs a table restores the selectors after it."""
    return _pair(hw, kind)


def _sel_key(s):
    return (s.bucket, s.strategy.tiles, s.strategy.backend, s.backend,
            s.grid, s.padded_m, s.predicted_cost)


def _table_key(t):
    return t.m_max, t.starts, [_sel_key(e) for e in t.entries]


MS = (1, 7, 33, 100, 191, 513)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("hw", HWS)
def test_selector_calibration_surface_matches_reference(hw, kind):
    pk, rk = _analytical_pair(hw, kind)
    ps, rs = pk.selector, rk.selector
    n = ps.stacked.num_candidates
    assert n == rs.stacked.num_candidates
    for m in MS:
        np.testing.assert_allclose(ps.candidate_costs(m),
                                   rs.candidate_costs(m), rtol=1e-12)
        for k in (1, 3, 5):
            assert ps.rank_candidates(m, k) == rs.rank_candidates(m, k)
        for idx in {*ps.rank_candidates(m, 4), 0, n - 1}:
            assert _sel_key(ps.candidate_selection(idx, m)) == \
                _sel_key(rs.candidate_selection(idx, m))

        def keyfn(s):
            return (s.backend, s.strategy.tiles)

        excluded = {keyfn(ps.candidate_selection(i, m))
                    for i in ps.rank_candidates(m, 2)}
        got = ps.select_excluding(m, excluded, keyfn)
        want = rs.select_excluding(m, excluded, keyfn)
        assert keyfn(got) not in excluded
        assert _sel_key(got)[:-1] == _sel_key(want)[:-1]
    st = ps.stacked
    everything = {(st.backend_of(i), st.strategy_for(i).tiles)
                  for i in range(n)}
    assert ps.select_excluding(33, everything, keyfn) is None
    assert rs.select_excluding(33, everything, keyfn) is None


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("hw", HWS)
def test_calibrated_tables_match_reference(hw, kind):
    """The same seeded cost_scale and pins give identical starts and
    entries, and None/None is the analytical table bit for bit."""
    pk, rk = _analytical_pair(hw, kind)
    ps, rs = pk.selector, rk.selector
    n = ps.stacked.num_candidates
    rng = np.random.default_rng(5)
    scale = rng.uniform(0.5, 2.0, n)
    pinned = {int(m): int(rng.integers(0, n)) for m in (3, 40, 77, 300)}
    args = (512, ps._num_cores)
    for cs, pins in ((None, None), (scale, None), (None, pinned),
                     (scale, pinned)):
        got = build_selection_table(ps._hw, ps.workload, ps.stacked, *args,
                                    cost_scale=cs, pinned=pins)
        want = _ref().build_table(rs._hw, rs.workload, rs.stacked, *args,
                                  cost_scale=cs, pinned=pins)
        assert _table_key(got) == _table_key(want)
    assert _table_key(ps.build_calibrated_table(512)) == _table_key(
        ps._build_table(512))


def _synthetic_seconds(mode: str):
    """Deterministic seconds per (extent, candidate): a per-backend
    multiple of the analytical cost with a fixed jitter, small for a good
    fit ("coefficients"), large for a bad one ("rerank")."""
    jitter = 0.1 if mode == "coefficients" else 1.8

    def seconds(m, idx, cost, backend):
        h = ((m * 7919 + idx * 104729) % 997) / 997.0 - 0.5
        alpha = 3.0 if backend == "mxu" or backend == "vector" else 5.0
        return alpha * cost * (1.0 + jitter * h)

    return seconds


def _fake_minima(cal, seconds):
    """An ``interleaved_minima`` for ``cal``'s one calibratable kernel that
    times nothing: the k-th call measures the k-th planned bucket and
    returns ``seconds`` for its candidates in the calibrator's order."""
    (st,) = [s for s in cal._states.values() if s.skipped is None]
    sel, plan = st.kernel.selector, iter(list(st.pending))

    def fake(calls, **kw):
        m = next(plan)
        costs = sel.candidate_costs(m)
        idxs = sel.rank_candidates(m, cal.policy.top_k)
        a = int(np.argmin(costs))
        if a not in idxs:
            idxs.append(a)
        assert len(calls) == len(idxs)
        return types.SimpleNamespace(rounds=1, best_s=tuple(
            seconds(m, i, float(costs[i]), sel.stacked.backend_of(i))
            for i in idxs))

    return fake


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("hw", HWS)
def test_calibrator_decisions_match_reference(hw, kind, tmp_path,
                                              monkeypatch):
    """Both fits: a good one ("coefficients") and a bad one ("rerank"),
    each calibrating the same kernels afresh (a calibrator plans and
    ranks from the unscaled analytical costs, whatever is installed)."""
    pk, rk = _analytical_pair(hw, kind)
    for sel in (pk.selector, rk.selector):
        # The pair is shared: every table this test installs is undone.
        for name in ("_table", "_cost_scale", "_pinned"):
            monkeypatch.setattr(sel, name, getattr(sel, name))
        monkeypatch.setattr(sel, "_cache", type(sel._cache)(sel._cache))
        monkeypatch.setattr(sel, "stats", dataclasses.replace(sel.stats))
    # The reference lowers and compiles each candidate before timing it;
    # the synthetic timings never run them, so skip XLA's compile.
    monkeypatch.setattr(_ref().jax, "jit", lambda fn: types.SimpleNamespace(
        lower=lambda *a: types.SimpleNamespace(compile=lambda: fn)))
    # The one divergence (ROADMAP C7, pinned by its own test below): a
    # backend with no measurement takes the largest fitted coefficient.
    monkeypatch.setattr(_ref().calibrate.Calibrator, "_scale_vector",
                        calibrate.Calibrator._scale_vector)
    for mode in ("coefficients", "rerank"):
        _check_decisions(pk, rk, mode, tmp_path / mode, monkeypatch)


def _check_decisions(pk, rk, mode, tmp_path, monkeypatch):
    swaps = pk.selector.stats.table_swaps
    cals = []
    for mod, kern, eng_cache in ((calibrate, pk, "port"),
                                 (_ref().calibrate, rk, "ref")):
        cal = mod.Calibrator(lambda k=kern: [k], mod.CalibrationPolicy(
            top_k=3, cache_dir=str(tmp_path / eng_cache), **SMOKE))
        assert cal.pending()
        monkeypatch.setattr(mod, "interleaved_minima",
                            _fake_minima(cal, _synthetic_seconds(mode)))
        cal.run()
        cals.append(cal)
    pc, rc = cals
    (ps,), (rs,) = pc._states.values(), rc._states.values()
    assert sorted(ps.measured) == sorted(rs.measured)
    assert ps.mode == rs.mode == mode
    assert ps.pinned == rs.pinned
    assert ps.residual == pytest.approx(rs.residual, rel=1e-12)
    assert ps.backend_scale.keys() == rs.backend_scale.keys()
    for b, a in ps.backend_scale.items():
        assert a == pytest.approx(rs.backend_scale[b], rel=1e-12)
    assert _table_key(pk.selector.table) == _table_key(rk.selector.table)
    assert pk.selector.stats.table_swaps == rk.selector.stats.table_swaps \
        == swaps + 1
    (prep,), (rrep,) = pc.report().values(), rc.report().values()
    for key in ("mode", "measured_buckets", "pinned_buckets",
                "agreement_rate", "never_worse_on_measured"):
        assert prep[key] == rrep[key], key
    assert prep["never_worse_on_measured"]
    assert prep["mean_regret_vs_best"] == pytest.approx(
        rrep["mean_regret_vs_best"], rel=1e-12, abs=1e-15)
    for pb, rb in zip(prep["buckets"], rrep["buckets"]):
        assert pb["m"] == rb["m"]
        for key in ("analytical_us", "best_us", "calibrated_us"):
            assert pb[key] == pytest.approx(rb[key], rel=1e-12), key
    pst, rst = pc.stats(), rc.stats()
    for key in ("kernels", "applied", "skipped", "measurements",
                "measured_buckets", "fits", "reranks", "table_swaps",
                "saves"):
        assert pst[key] == rst[key], key


# ---------------------------------------------------------------------------
# Off-path exactness: calibration hooks default to bit-identical behaviour
# ---------------------------------------------------------------------------


def test_off_is_default_and_builds_no_calibrator():
    eng = gemm_engine()
    assert eng.config.calibration == "off"
    assert eng.calibrator is None
    assert eng.stats()["calibration"] == {"enabled": False, "mode": "off"}
    sel = only_kernel(eng).selector
    assert sel._cost_scale is None and sel._pinned == {}
    assert sel.stats.table_swaps == 0


def test_hooks_default_to_bit_identical_tables():
    eng = gemm_engine()
    sel = only_kernel(eng).selector
    base = sel.table
    rebuilt = build_selection_table(
        sel._hw, sel.workload, sel.stacked, base.m_max,
        cost_scale=None, pinned=None,
    )
    unit = build_selection_table(
        sel._hw, sel.workload, sel.stacked, base.m_max,
        cost_scale=np.ones(sel.stacked.num_candidates),
    )
    for other in (rebuilt, unit):
        assert other.starts == base.starts
        for a, b in zip(other.entries, base.entries):
            assert (a.strategy, a.backend, a.grid) == (
                b.strategy, b.backend, b.grid
            )
            assert a.predicted_cost == b.predicted_cost


def test_bad_calibration_mode_rejected():
    with pytest.raises(ValueError, match="calibration"):
        EngineConfig(device="cpu", calibration="sometimes")


# ---------------------------------------------------------------------------
# cost_scale / pinned table semantics
# ---------------------------------------------------------------------------


def test_cost_scale_reranks_consistently_with_scaled_argmin():
    sel = only_kernel(gemm_engine()).selector
    st = sel.stacked
    # Make one arbitrary non-winning candidate free: it must win everywhere.
    m = 100
    base_winner = int(np.argmin(sel.candidate_costs(m)))
    forced = (base_winner + 1) % st.num_candidates
    scale = np.ones(st.num_candidates)
    scale[forced] = 1e-9
    table = sel.build_calibrated_table(cost_scale=scale)
    got = table.lookup(m)
    assert (got.strategy, got.backend) == (
        st.strategy_for(forced), st.backend_of(forced)
    )


def test_pinned_overrides_exactly_the_containing_interval():
    sel = only_kernel(gemm_engine()).selector
    st = sel.stacked
    base = sel.table
    m_pin = 100
    # Pins override the PRE-merge breakpoint interval containing the
    # measured extent (cost is constant there, so one measurement speaks
    # for the whole interval).
    starts = merge_breakpoints(
        st.dynamic_periods(sel.workload.dynamic_tile_axes), base.m_max
    )
    b = bisect.bisect_right(starts, m_pin) - 1
    lo = starts[b]
    hi = starts[b + 1] - 1 if b + 1 < len(starts) else base.m_max
    winner = int(np.argmin(sel.candidate_costs(m_pin)))
    forced = (winner + 1) % st.num_candidates
    table = sel.build_calibrated_table(pinned={m_pin: forced})
    fstrat = st.strategy_for(forced)
    for m in {lo, m_pin, hi}:
        assert table.lookup(m).strategy == fstrat
    if lo > 1:
        assert table.lookup(lo - 1).strategy == base.lookup(lo - 1).strategy


# ---------------------------------------------------------------------------
# Atomic swap
# ---------------------------------------------------------------------------


def test_install_validates_table():
    sel = only_kernel(gemm_engine()).selector
    bad = dataclasses.replace(sel.table, starts=[2] + sel.table.starts[1:])
    with pytest.raises(ValueError, match="cover extents from 1"):
        sel.install_table(bad)


def test_swap_is_idempotent():
    sel = only_kernel(gemm_engine()).selector
    table = sel.build_calibrated_table()
    before = sel.select(77)
    sel.install_table(table)
    sel.install_table(table)
    assert sel.stats.table_swaps == 2
    assert sel.table is table
    after = sel.select(77)
    assert (after.strategy, after.backend, after.grid) == (
        before.strategy, before.backend, before.grid
    )


def test_threaded_dispatch_survives_concurrent_swaps():
    """Worker threads dispatch gemm while the main thread swaps the
    analytical and a re-ranked table back and forth: every result is the
    reference product, and calls == launches with zero padded calls."""
    kern = only_kernel(gemm_engine())
    sel = kern.selector
    st = sel.stacked
    w = _arr(64, 64)
    ms = [5, 33, 77, 101]
    xs = {m: _arr(m, 64) for m in ms}
    refs = {m: (xs[m].double() @ w.double()).float() for m in ms}

    analytical = sel.build_calibrated_table()
    flipped_scale = np.ones(st.num_candidates)
    flipped_scale[int(np.argmin(sel.candidate_costs(64)))] = 1e3
    flipped = sel.build_calibrated_table(cost_scale=flipped_scale)
    assert any(
        a.strategy != b.strategy
        for a, b in zip(analytical.entries, flipped.entries)
    ), "the flipped table must change winners for the stress to bite"

    base = kern.dispatch_stats.as_dict()
    errors: list = []
    stop = threading.Event()
    done = []

    def worker(i):
        try:
            n = 0
            while not stop.is_set() or n < 8:
                m = ms[(i + n) % len(ms)]
                torch.testing.assert_close(kern(xs[m], w), refs[m],
                                           rtol=2e-4, atol=2e-4)
                n += 1
                if n >= 200:
                    break
            done.append(n)
        except Exception as exc:  # pragma: no cover - failure path
            errors.append((i, exc))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for _ in range(50):
        sel.install_table(flipped, cost_scale=flipped_scale)
        sel.install_table(analytical)
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors[:2]
    assert sel.stats.table_swaps == 100
    delta = {
        k: v - base[k] for k, v in kern.dispatch_stats.as_dict().items()
    }
    assert delta["calls"] == sum(done)
    assert delta["launches"] == delta["calls"]
    assert delta["padded_calls"] == 0


# ---------------------------------------------------------------------------
# Persistence: fingerprint-keyed cache under ~/.cache/vortex
# ---------------------------------------------------------------------------


def test_cache_dir_resolution(tmp_path, monkeypatch):
    monkeypatch.delenv("VORTEX_CACHE_DIR", raising=False)
    assert calibration_cache_dir() == os.path.expanduser("~/.cache/vortex")
    monkeypatch.setenv("VORTEX_CACHE_DIR", str(tmp_path / "env"))
    assert calibration_cache_dir() == str(tmp_path / "env")
    assert calibration_cache_dir(str(tmp_path / "x")) == str(tmp_path / "x")
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    assert not calibration_cache_dir().startswith(repo)


def test_persistence_roundtrip_zero_remeasurements(cache_dir):
    eng = gemm_engine(calibration="on-idle")
    cal = calibrated(eng)
    assert cal.stats()["applied"] == 1
    assert cal.counters["saves"] >= 1

    eng2 = gemm_engine(calibration="on-idle")
    cal2 = eng2.calibrator
    cal2.policy = dataclasses.replace(cal2.policy, **SMALL)
    assert launch_calibration.warm_from_disk(eng2) == 1
    assert cal2.counters["measurements"] == 0
    assert not cal2.pending()
    sel2 = only_kernel(eng2).selector
    assert sel2.stats.table_swaps == 1
    sel1 = only_kernel(eng).selector
    for m in (5, 33, 77, 101):
        assert sel1.select(m).strategy == sel2.select(m).strategy
    assert launch_calibration.warm_from_disk(gemm_engine()) == 0  # off


def test_fingerprint_mismatch_rejects_stale_table(cache_dir):
    cal = calibrated(gemm_engine(calibration="on-idle"))
    path = cal.cache_path()
    with open(path) as f:
        data = json.load(f)
    data["fingerprint"]["hardware"] = "some_other_chip"
    with open(path, "w") as f:
        json.dump(data, f)
    assert fingerprint_key(data["fingerprint"]) != os.path.splitext(
        os.path.basename(path))[0]
    eng2 = gemm_engine(calibration="on-idle")
    cal2 = eng2.calibrator
    assert cal2.load(path) == 0
    assert cal2.counters["load_rejects"] == 1
    assert only_kernel(eng2).selector.stats.table_swaps == 0


def test_stale_lattice_checksum_rejected(cache_dir):
    cal = calibrated(gemm_engine(calibration="on-idle"))
    path = cal.cache_path()
    with open(path) as f:
        data = json.load(f)
    for entry in data["kernels"].values():
        entry["lattice"] = "deadbeefdeadbeef"
    with open(path, "w") as f:
        json.dump(data, f)
    cal2 = gemm_engine(calibration="on-idle").calibrator
    assert cal2.load() == 0
    assert cal2.counters["load_rejects"] == 1


def test_truncated_cache_file_falls_back_to_analytical(cache_dir):
    cal = calibrated(gemm_engine(calibration="on-idle"))
    path = cal.cache_path()
    blob = open(path).read()
    with open(path, "w") as f:
        f.write(blob[: len(blob) // 2])  # torn write / killed process
    eng2 = gemm_engine(calibration="on-idle")
    cal2 = eng2.calibrator
    assert cal2.load() == 0
    assert cal2.counters["load_rejects"] == 1
    sel = only_kernel(eng2).selector
    assert sel.select(33).predicted_cost > 0
    assert sel.stats.table_swaps == 0
    assert cal2.pending()  # measurement work remains: nothing was applied


def test_missing_cache_file_is_not_an_error(cache_dir):
    cal = gemm_engine(calibration="on-idle").calibrator
    assert cal.load() == 0
    assert cal.counters["load_rejects"] == 0


def test_lattice_checksum_tracks_candidate_space():
    st = only_kernel(gemm_engine()).selector.stacked
    assert lattice_checksum(st) == lattice_checksum(st)
    assert lattice_checksum(
        dataclasses.replace(st, l1_costs=st.l1_costs * 1.01)
    ) != lattice_checksum(st)
    assert lattice_checksum(
        dataclasses.replace(st, l1_tiles=st.l1_tiles[::-1].copy())
    ) != lattice_checksum(st)


def test_fingerprint_follows_the_kernel_sources(monkeypatch):
    """For ``impl="cuda"`` the fingerprint holds the digest of the kernel
    sources (an edited kernel changes every measured time); the plain
    versions' fingerprint has none.  It names torch and the device."""
    from repro_torch.core.hardware import get_hardware
    from repro_torch.kernels import build

    hw = get_hardware("h100_sxm")
    backends = tuple(sorted(hw.backends))
    fp = hardware_fingerprint(hw, backends, "cuda", "cpu")
    assert fp["kernel_sources"] == build.source_digest()
    assert fp["torch"] == torch.__version__
    assert fp["device"].startswith("cpu:")
    assert "jax" not in fp and "interpret" not in fp
    monkeypatch.setattr(build, "source_digest", lambda: "0" * 16)
    edited = hardware_fingerprint(hw, backends, "cuda", "cpu")
    assert fingerprint_key(edited) != fingerprint_key(fp)
    plain = hardware_fingerprint(hw, backends, "torch", "cpu")
    assert "kernel_sources" not in plain


# ---------------------------------------------------------------------------
# Persistence and measurement under injected faults: counted, never raised
# ---------------------------------------------------------------------------


def test_save_fault_at_open_counted_never_raises(cache_dir):
    eng = gemm_engine(calibration="on-idle")
    cal = eng.calibrator
    cal.policy = dataclasses.replace(cal.policy, **SMALL)
    with faults.installed(faults.FaultPlan({"cache_io": [1]})):
        cal.run()
    assert cal.counters["save_errors"] == 1
    assert cal.counters["store_rejects"] == 1
    assert not os.path.exists(cal.cache_path())
    assert cal.stats()["applied"] == 1
    cal.save()
    assert os.path.exists(cal.cache_path())


def test_save_fault_before_replace_leaves_no_partial_file(cache_dir):
    eng = gemm_engine(calibration="on-idle")
    cal = eng.calibrator
    cal.policy = dataclasses.replace(cal.policy, **SMALL)
    with faults.installed(faults.FaultPlan({"cache_io": [2]})):
        cal.run()
    assert cal.counters["store_rejects"] == 1
    path = cal.cache_path()
    assert not os.path.exists(path)
    assert os.path.exists(path + ".tmp")  # the orphaned tmp file
    cal2 = gemm_engine(calibration="on-idle").calibrator
    assert cal2.load() == 0
    assert cal2.counters["load_rejects"] == 0


def test_load_fault_counted_as_reject(cache_dir):
    calibrated(gemm_engine(calibration="on-idle"))
    cal2 = gemm_engine(calibration="on-idle").calibrator
    cal2.policy = dataclasses.replace(cal2.policy, **SMALL)
    with faults.installed(faults.FaultPlan({"cache_io": [1]})):
        assert cal2.load() == 0
    assert cal2.counters["load_rejects"] == 1
    assert cal2.load() == 1
    assert cal2.counters["measurements"] == 0


def test_measure_fault_skips_kernel_not_calibrator(cache_dir):
    eng = gemm_engine(calibration="on-idle")
    cal = eng.calibrator
    cal.policy = dataclasses.replace(cal.policy, **SMALL)
    with faults.installed(faults.FaultPlan({"calib_measure": [1]})):
        cal.run()
    s = cal.stats()
    assert s["applied"] == 0 and s["skipped"] == 1
    assert cal.skipped() == {"gemm": "measurement failed"}
    assert cal.counters["measurements"] == 0
    eng.dispatch("gemm", _arr(45, 64), _arr(64, 64))


# ---------------------------------------------------------------------------
# Calibrator behaviour on live engines
# ---------------------------------------------------------------------------


def test_calibration_pins_make_measured_buckets_match_best(cache_dir):
    rep = calibrated(gemm_engine(calibration="on-idle")).report()["gemm"]
    assert rep["measured_buckets"] >= 1
    assert rep["never_worse_on_measured"]
    assert 0.0 <= rep["agreement_rate"] <= 1.0
    assert rep["mode"] in ("coefficients", "rerank")
    for b in rep["buckets"]:
        assert b["calibrated_idx"] == b["best_idx"]
        assert 2 <= sum(b["candidates"].values()) <= SMALL["top_k"] + 1
        assert SMALL["min_rounds"] <= b["rounds"] <= SMALL["max_rounds"]


def test_exec_specialized_kernels_are_skipped(cache_dir):
    eng = gemm_engine(calibration="on-idle")
    kv = _arr(1, 2, 33, 64)
    eng.dispatch("attention", _arr(1, 4, 33, 64), kv, kv)
    cal = calibrated(eng)
    s = cal.stats()
    assert s["skipped"] == 1 and s["applied"] == 1
    assert cal.skipped() == {
        "attention": "exec-specialized (needs representative args)"}


def test_stats_surface_engine_and_selector_counters(cache_dir):
    eng = gemm_engine(calibration="on-idle")
    calibrated(eng)
    st = eng.stats()
    assert st["calibration"]["enabled"]
    assert st["calibration"]["table_swaps"] == 1
    assert st["gemm"]["table_swaps"] == 1
    assert st["gemm"]["calibration_seconds"] > 0
    sel = only_kernel(eng).select_stats
    assert sel["table_swaps"] == 1 and sel["calibration_seconds"] > 0


def test_calibration_stays_off_the_serving_ledger(cache_dir):
    """Measurements build their own executables: the kernel's executable
    cache, DispatchStats and staging pools are untouched."""
    eng = gemm_engine(calibration="on-idle")
    kern = only_kernel(eng)
    before = (kern.dispatch_stats.as_dict(), kern.cache_info["entries"],
              len(kern.staging_sets()))
    calibrated(eng)
    assert (kern.dispatch_stats.as_dict(), kern.cache_info["entries"],
            len(kern.staging_sets())) == before


def test_eager_warmup_calibrates_at_build(cache_dir):
    cfg = dict(calibration="eager-warmup", calibration_top_k=2,
               calibration_budget_s=10.0)
    eng = Engine("host_cpu", device="cpu", empirical_levels=(), **cfg)
    eng.calibrator.policy = dataclasses.replace(eng.calibrator.policy,
                                                **SMALL)
    eng.dispatch("gemm", _arr(33, 64), _arr(64, 64))
    s = eng.stats()["calibration"]
    assert s["applied"] == 1 and s["measured_buckets"] >= 1

    eng2 = Engine("host_cpu", device="cpu", empirical_levels=(), **cfg)
    eng2.calibrator.policy = dataclasses.replace(eng2.calibrator.policy,
                                                 **SMALL)
    eng2.dispatch("gemm", _arr(33, 64), _arr(64, 64))
    s2 = eng2.stats()["calibration"]
    assert s2["applied"] == 1
    assert s2["loaded_from_disk"] == 1
    assert s2["measurements"] == 0


def test_cli_runs_on_the_cpu_and_reloads(tmp_path, capsys):
    """``python -m repro_torch.launch.calibration --device cpu --smoke``:
    gemm and conv2d calibrate, attention is skipped, exit 0; the second
    run loads every table from disk."""
    args = ["--device", "cpu", "--smoke", "--cache-dir", str(tmp_path),
            "--json", str(tmp_path / "report.json")]
    assert launch_calibration.main(args) == 0
    out = capsys.readouterr().out
    assert "attention: skipped (exec-specialized" in out
    rep = json.loads((tmp_path / "report.json").read_text())
    assert set(rep["report"]) == {"gemm", "conv2d"}
    assert all(r["never_worse_on_measured"] for r in rep["report"].values())
    assert rep["stats"]["saves"] >= 1
    assert launch_calibration.main(args) == 0
    again = json.loads((tmp_path / "report.json").read_text())
    assert again["stats"]["loaded_from_disk"] == 2
    assert again["stats"]["measurements"] == 0


def test_run_calibration_refuses_an_engine_with_calibration_off():
    with pytest.raises(ValueError, match="calibration"):
        launch_calibration.run_calibration(gemm_engine())


# ---------------------------------------------------------------------------
# Port-only: what is measured, and never during a capture
# ---------------------------------------------------------------------------


def _recording_minima(seen: list):
    """An ``interleaved_minima`` that calls each variant once, records the
    outputs' dtypes and devices, and reports equal times."""

    def fake(calls, **kw):
        for fn in calls:
            out = fn()
            seen.append((out.dtype, out.device))
        return types.SimpleNamespace(best_s=(1e-3,) * len(calls), rounds=1)

    return fake


def test_measurements_use_the_served_dtype(cache_dir, monkeypatch):
    """ROADMAP C5: a kernel that served bf16 is measured in bf16 on its
    device (the reference measures float32 whatever it served, which on
    the card would time the FMA loop in place of the wgmma tile); one
    that served nothing is measured in bf16 on the card, float32 on the
    CPU."""
    seen: list = []
    monkeypatch.setattr(calibrate, "interleaved_minima",
                        _recording_minima(seen))
    eng = Engine("host_cpu", device="cpu", empirical_levels=(),
                 calibration="on-idle")
    eng.dispatch("gemm", _arr(33, 64, dtype=torch.bfloat16),
                 _arr(64, 64, dtype=torch.bfloat16))
    kern = only_kernel(eng)
    assert kern.served_as == (torch.bfloat16, torch.device("cpu"))
    calibrated(eng)
    assert seen and set(seen) == {(torch.bfloat16, torch.device("cpu"))}

    unserved = eng.kernel_for(GroupedGemmWorkload(C=None, G=4, E=2, N=8,
                                                  K=16))
    assert unserved.served_as is None
    assert eng.calibrator.measure_as(unserved) == (torch.float32,
                                                   torch.device("cpu"))
    card = Calibrator(lambda: [], device="cuda")
    assert card.measure_as(unserved) == (torch.bfloat16,
                                         torch.device("cuda"))


def test_unmeasured_backend_keeps_its_analytical_standing(tmp_path,
                                                          monkeypatch):
    """ROADMAP C7: after a good fit in which only one backend's candidates
    were measured, the other backend takes the largest fitted coefficient,
    so it wins no extent it did not win analytically.  With the
    reference's coefficient of 1.0 it would look ``alpha`` times cheaper
    and take the unpinned extents (on the card: conv2d's table went to
    cuda_core at 4,088 of 4,096 extents)."""
    eng = Engine("h100_sxm", device="cpu", empirical_levels=(),
                 calibration="on-idle", calibration_cache_dir=str(tmp_path))
    eng.dispatch("gemm", _arr(33, 768), _arr(768, 768))
    cal = eng.calibrator
    cal.policy = dataclasses.replace(cal.policy, **SMOKE)
    assert cal.pending()
    monkeypatch.setattr(calibrate, "interleaved_minima", _fake_minima(
        cal, lambda m, idx, cost, backend: 40.0 * cost))
    cal.run()
    (st,) = cal._states.values()
    sel = st.kernel.selector
    assert st.mode == "coefficients" and set(st.backend_scale) == {"tensor_core"}
    analytical = sel.build_calibrated_table()
    share = {b: sum(e.backend == b for e in sel.table.entries)
             for b in ("tensor_core", "cuda_core")}
    assert share == {b: sum(e.backend == b for e in analytical.entries)
                     for b in ("tensor_core", "cuda_core")}
    assert st.pinned == {}
    reference_rule = np.asarray([
        st.backend_scale.get(sel.stacked.backend_of(i), 1.0)
        for i in range(sel.stacked.num_candidates)])
    promoted = sel.build_calibrated_table(cost_scale=reference_rule)
    assert sum(e.backend == "cuda_core" for e in promoted.entries) > share["cuda_core"]


def test_grouped_example_counts_fill_the_bucket():
    """ROADMAP C6: the grouped GEMM's example counts are the bucket extent
    in every group (the kernel issues no work past a count; the
    reference's zero counts would time an empty launch)."""
    eng = Engine("tpu_v5e", device="cpu", empirical_levels=())
    kern = eng.kernel_for(GroupedGemmWorkload(C=None, G=6, E=3, N=16, K=32))
    for c in (1, 20, 129):
        sel = kern.select(c)
        x, w, counts = kern.workload.example_args(
            sel, dtype=torch.bfloat16, device="cpu")
        assert x.shape == (6, sel.padded_m, 32) and x.dtype == torch.bfloat16
        assert w.shape == (3, 32, 16)
        assert counts.dtype == torch.int32
        assert counts.tolist() == [sel.padded_m] * 6
        out = kern.workload.build_executable(sel, impl="torch")(x, w, counts)
        assert out.shape == (6, sel.padded_m, 16)


def test_no_measurement_during_a_graph_capture(cache_dir, monkeypatch):
    """A measurement refuses to run while the calling thread captures a
    CUDA graph; inside a slice that marks the kernel skipped and leaves
    its analytical table serving."""
    eng = gemm_engine(calibration="on-idle")
    cal = eng.calibrator
    cal.policy = dataclasses.replace(cal.policy, **SMALL)
    assert cal.pending()
    (st,) = cal._states.values()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        cal._measure_bucket(st, st.pending[0])
    cal.run_slice()
    assert cal.skipped() == {"gemm": "measurement failed"}
    assert only_kernel(eng).selector.stats.table_swaps == 0


def test_daemon_slices_never_overlap_a_graph_capture(monkeypatch,
                                                     tmp_path):
    """A ``CalibrationDaemon`` started while a decode step is being
    captured (stub capture on the CPU) takes no calibrator step until the
    capture ends: the capture holds the calibrator's lock."""
    from repro_torch.configs.paper_gpt2 import SMOKE as GPT2_SMOKE
    from repro_torch.launch.serve import Request, VortexServer

    cfg = dataclasses.replace(GPT2_SMOKE, dtype="float32")
    eng = Engine(EngineConfig(
        hardware="tpu_v5e", backends=("mxu",), device="cpu",
        calibration="on-idle", calibration_cache_dir=str(tmp_path)))
    srv = VortexServer(cfg, max_cache=64, engine=eng, graphs=True)
    cal = eng.calibrator
    events: list[str] = []
    real_sync = cal._sync

    def sync():
        events.append("calibrator")
        real_sync()

    monkeypatch.setattr(cal, "_sync", sync)
    daemon = launch_calibration.CalibrationDaemon(eng, interval_s=0.01)

    def capture(fn, pool, stream):
        events.append("capture begins")
        if daemon._thread is None:
            daemon.start()
        time.sleep(0.2)  # the daemon's first load() would run here
        out = fn()
        events.append("capture ends")
        return types.SimpleNamespace(replay=lambda: None), out

    monkeypatch.setattr(graphs, "capture_graph", capture)
    try:
        srv.generate(Request(tokens=np.ones((1, 5), np.int64), max_new=2))
        deadline = time.monotonic() + 5
        while "calibrator" not in events and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        daemon.stop()
    first = events.index("capture begins")
    assert events[first + 1] == "capture ends", events
    assert "calibrator" in events[first + 2:]


# ---------------------------------------------------------------------------
# Scheduler idle donation
# ---------------------------------------------------------------------------


class _StubCalibrator:
    lock = threading.RLock()

    def __init__(self):
        self.slices = 0
        self._pending = True

    def pending(self):
        return self._pending

    def run_slice(self, budget_s=None):
        self.slices += 1
        self._pending = False
        return 1


@pytest.fixture(scope="module")
def sched_server(tmp_path_factory):
    from repro_torch.configs.paper_gpt2 import SMOKE as GPT2_SMOKE
    from repro_torch.launch.serve import VortexServer

    engine = Engine(EngineConfig(
        hardware="tpu_v5e", backends=("mxu",), device="cpu",
        calibration="on-idle",
        calibration_cache_dir=str(tmp_path_factory.mktemp("vortex-cache")),
    ))
    cfg = dataclasses.replace(GPT2_SMOKE, dtype="float32")
    return VortexServer(cfg, max_cache=64, engine=engine)


def test_scheduler_donates_only_when_idle(sched_server):
    from repro_torch.launch.scheduler import ContinuousScheduler

    sched = ContinuousScheduler(sched_server, batch_rows=2)
    stub = _StubCalibrator()
    sched_server.engine._calibrator = stub
    try:
        worked = sched.step()  # no queue, no rows -> donate one slice
        assert worked is False  # donation never counts as request work
        assert stub.slices == 1
        assert sched.stats["calibration_slices"] == 1
        sched.step()  # nothing pending: no second slice
        assert stub.slices == 1
    finally:
        sched_server.engine._calibrator = None
        sched.close()


def test_scheduler_drain_terminates_with_pending_calibration(sched_server):
    from repro_torch.launch.scheduler import ContinuousScheduler
    from repro_torch.launch.serve import Request

    class Greedy(_StubCalibrator):
        def run_slice(self, budget_s=None):  # never finishes
            self.slices += 1
            self.busy.append(any(r is not None for r in sched.rows)
                             or bool(sched._queue))
            return 1

    sched = ContinuousScheduler(sched_server, batch_rows=2)
    stub = Greedy()
    stub.busy = []
    sched_server.engine._calibrator = stub
    try:
        tokens = np.array([[1, 2, 3]], np.int64)
        rid = sched.submit(Request(tokens=tokens, max_new=2))
        out = sched.drain()  # must terminate despite endless pending()
        assert rid in out and out[rid].shape == (1, 2)
        assert stub.slices >= 1  # the idle tail of the drain donated
        assert not any(stub.busy)  # never while a row or request waited
    finally:
        sched_server.engine._calibrator = None
        sched.close()


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_calibrates_a_bf16_gemm_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")
    from repro_torch import kernels

    eng = Engine(device="cuda", empirical_levels=(), calibration="on-idle",
                 calibration_cache_dir=str(tmp_path))
    a = torch.randn(33, 768, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(768, 768, device="cuda", dtype=torch.bfloat16)
    eng.dispatch("gemm", a, b)
    cal = eng.calibrator
    cal.policy = dataclasses.replace(cal.policy, **SMOKE)
    kernels.reset_launch_counts()
    out = launch_calibration.run_calibration(eng)
    counts = kernels.launch_counts()
    rep = out["report"]["gemm"]
    assert rep["measured_buckets"] >= 1 and rep["never_worse_on_measured"]
    assert counts["vortex_gemm"] == (counts["vortex_gemm.tensor_core"]
                                     + counts["vortex_gemm.cuda_core"]) > 0
    got = eng.dispatch("gemm", a, b)
    torch.testing.assert_close(got.float(), (a.float() @ b.float()),
                               rtol=2 ** -7, atol=0.5)
