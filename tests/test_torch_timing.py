"""The port's phase-robust timing harness (core/timing.py), held against
the JAX package's (src/repro/core/timing.py): the same arguments, stop rule
and sample format, the same retry telemetry on the same measurement
sequences.  Mirrors tests/test_calibration.py's timing cases.
"""
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from repro.core import timing as ref_timing  # noqa: E402

from repro_torch.core import timing  # noqa: E402
from repro_torch.core.timing import interleaved_minima, retry_best  # noqa: E402


def test_interleaved_minima_basics():
    t = interleaved_minima(
        [lambda: np.zeros(4), lambda: torch.zeros(4)],
        inner=1, min_rounds=3, max_rounds=5, patience=1,
    )
    assert 3 <= t.rounds <= 5
    assert len(t.best_s) == 2 and all(b > 0 for b in t.best_s)
    assert len(t.samples_us[0]) == len(t.samples_us[1]) == t.rounds
    assert t.ratio(0, 1) == pytest.approx(t.best_s[0] / t.best_s[1])
    # Samples are microseconds rounded to ns, as the reference keeps them.
    assert all(s == round(s, 3) for s in t.samples_us[0])
    assert min(t.samples_us[1]) == pytest.approx(t.best_s[1] * 1e6, abs=1e-3)


@pytest.mark.parametrize("mod", [timing, ref_timing], ids=["port", "ref"])
def test_interleaved_minima_rejects_empty(mod):
    with pytest.raises(ValueError):
        mod.interleaved_minima([])


@pytest.mark.parametrize("kw", [
    dict(min_rounds=4, max_rounds=9, patience=2),
    dict(min_rounds=2, max_rounds=3, patience=10),
    dict(min_rounds=5, max_rounds=40, patience=3, inner=3),
], ids=["patience", "max_rounds", "inner"])
def test_stop_rule_and_samples_match_the_reference(kw, monkeypatch):
    """On the same clock both harnesses stop after the same round and keep
    the same samples: a clock whose windows shrink, then hold, improves
    the minimum for a few rounds, then stops it improving."""
    widths = [9.0, 7.0, 6.0, 5.0]  # µs per window, by round

    def run(mod):
        state = {"k": -1, "t": 0.0}

        def clock():
            # Tick 0 starts the deadline clock; then each window is an
            # odd tick (start, after a 1 s gap) and an even one (end).
            state["k"] += 1
            k = state["k"]
            if k:
                r = (k // 2 - 1) // 2  # the round this window belongs to
                state["t"] += 1.0 if k % 2 else \
                    widths[min(r, len(widths) - 1)] * 1e-6
            return state["t"]

        monkeypatch.setattr(time, "perf_counter", clock)
        return mod.interleaved_minima([lambda: None, lambda: None],
                                      warmup=False, **kw)

    got, want = run(timing), run(ref_timing)
    assert got.rounds == want.rounds
    assert got.samples_us == want.samples_us
    assert got.best_s == want.best_s
    assert got.rounds >= min(kw["min_rounds"], kw["max_rounds"])
    inner = kw.get("inner", 2)
    last = widths[min(got.rounds - 1, len(widths) - 1)]
    assert got.best_s[0] == pytest.approx(last * 1e-6 / inner)


def test_warmup_call_lands_outside_every_timed_window():
    calls = []

    def fn():
        calls.append(1)
        return torch.zeros(1)

    t = interleaved_minima([fn], inner=3, min_rounds=2, max_rounds=2,
                           patience=1)
    assert len(calls) == 1 + 3 * t.rounds


@pytest.mark.parametrize("seq,attempts", [
    ([5.0, 2.0, 4.0, 3.0], 4), ([5.0, 2.0, 0.5, 3.0], 4),
    ([0.5, 9.0], 4), ([7.0, 6.0, 8.0], 2),
])
def test_retry_best_matches_the_reference(seq, attempts):
    out = {}
    for name, mod in (("port", timing), ("ref", ref_timing)):
        vals = iter(seq)
        stats: dict = {}
        best = mod.retry_best(lambda: next(vals), attempts=attempts,
                              accept=lambda v: v < 1.0, key=lambda v: v,
                              stats=stats)
        out[name] = (best, stats)
    assert out["port"] == out["ref"]


def test_retry_best_keeps_smallest_key():
    vals = iter([5.0, 2.0, 4.0, 3.0])
    out = retry_best(
        lambda: next(vals), attempts=4,
        accept=lambda v: v < 1.0, key=lambda v: v,
    )
    assert out == 2.0


def test_retry_best_accept_short_circuits():
    calls = []

    def measure():
        calls.append(1)
        return 0.5

    assert retry_best(
        measure, attempts=5, accept=lambda v: v < 1.0, key=lambda v: v
    ) == 0.5
    assert len(calls) == 1


def test_synchronize_passes_outputs_through():
    out = (torch.ones(2), {"x": [torch.zeros(1)]})
    assert timing.synchronize(out) is out
    assert timing.synchronize(None) is None
