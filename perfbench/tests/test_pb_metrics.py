"""Readers: rates over the whole window and medians over every sample.
A stall put into a synthetic span list moves the rate."""
import types

import numpy as np
import pytest

from kit import spec
from kit.serving import Req, Step
from kit.stats import nearest_rank


def _run(stall_at=(), stall=0.0, n=40, steps=30, dt=0.02):
    """n requests due 0.1 s apart; each gets its first token 5 ms after
    its due time and one token every ``dt`` after that.  Each stall (at
    the times ``stall_at``, in seconds) delays everything after it by
    ``stall``."""
    t0 = 100.0
    run = types.SimpleNamespace(mix={"kind": "open_loop"}, t_window=t0,
                                t_close=t0 + 4.0, t_end=t0 + 6.0, reqs=[], pre=[],
                                steps=[], prefills=[])

    def at(t):
        return t + stall * sum(t >= s for s in stall_at)

    for i in range(n):
        due = 0.1 * i
        times = [t0 + at(due + 0.005 + k * dt) for k in range(steps)]
        r = Req(due, "chat", np.zeros((1, 8), np.int64), steps)
        r.times, r.out = times, np.zeros(steps, np.int64)
        r.prefill_start = t0 + at(due + 0.001)
        run.reqs.append(r)
    return types.SimpleNamespace(run=run, trace=None, model=None, setup_s=1.0)


def _read(name, ctx):
    return spec.reader(name)(ctx)


def test_a_stall_moves_the_rate():
    calm = _run(dt=0.05, steps=20)
    # A 0.3 s stall every 0.5 s delays every token after it.
    stalls = [0.5 * k + 0.02 for k in range(1, 8)]
    stalled = _run(stall_at=stalls, stall=0.3, dt=0.05, steps=20)
    assert _read("output_tokens_per_s", stalled) < \
        0.8 * _read("output_tokens_per_s", calm)


def test_rate_counts_the_whole_window():
    ctx = _run()
    run = ctx.run
    inside = sum(t <= run.t_close for r in run.reqs for t in r.times)
    assert _read("output_tokens_per_s", ctx) == pytest.approx(inside / 4.0)


def test_rate_counts_preroll_requests_read_back_inside():
    ctx = _run()
    run = ctx.run
    before = _read("output_tokens_per_s", ctx)
    early = Req(-1.0, "batch", np.zeros((1, 8), np.int64), 3)
    early.times = [run.t_window - 0.5, run.t_window + 0.5,
                   run.t_window + 1.5]
    run.pre.append(early)
    assert _read("output_tokens_per_s", ctx) == pytest.approx(
        before + 2 / 4.0)


def test_dispatch_median_is_over_every_call():
    host = [1e-6 * v for v in [50] * 60 + [500] * 41]
    ctx = types.SimpleNamespace(run=types.SimpleNamespace(host_s=host))
    assert _read("dispatch_host_us", ctx) == pytest.approx(50.0)
    host += [1e-6 * 500] * 20
    assert _read("dispatch_host_us", ctx) == pytest.approx(500.0)


def test_nearest_rank():
    assert nearest_rank(range(1, 101), 0.95) == 95
    assert nearest_rank([3.0], 0.5) == 3.0
    assert nearest_rank([1, 2, float("inf")], 0.95) == float("inf")


def test_decode_step_and_rows_per_step_read_the_window_only():
    ctx = _run()
    run = ctx.run
    run.steps = [Step(run.t_window + 0.1 * i, run.t_window + 0.1 * i + 0.03,
                      (1, 2, 3), (5, 6, 7)) for i in range(60)]
    ctx.window_steps = lambda: [s for s in run.steps
                                if run.t_window <= s.t0 < run.t_close]
    assert _read("decode_step_ms.batch", ctx) == pytest.approx(30.0)
    assert _read("rows_per_step", ctx) == pytest.approx(3.0)
