"""The traced slice of a serving run: it lasts ``trace_s`` and then runs on
until it holds a prefill, so that the prefill readers always find one;
with no prefill it ends at the window's close."""
import pytest

from kit import serving
from kit.serving import Prefill, ServeRun


class _FakeSlice:
    """Stands in for the profiler: starts at the tick's own time."""

    clock = 0.0

    def __init__(self):
        self.stopped = False

    def start(self):
        self.t_started = _FakeSlice.clock

    def stop(self):
        self.stopped = True


@pytest.fixture
def run(monkeypatch):
    monkeypatch.setattr(serving, "Slice", _FakeSlice)
    r = ServeRun({"model": {}}, {"trace_s": 2.0}, {"kind": "closed_loop"},
                 seed=1, seconds=10.0, trace=True, device="cpu")
    r.t_window, r.t_close = 0.0, 10.0
    return r


def _tick(r, now):
    _FakeSlice.clock = now
    r._trace_tick(now)


def test_slice_waits_for_a_prefill_past_trace_s(run):
    _tick(run, 4.0)  # 40% of the window
    assert run.trace is not None and not run.trace.stopped
    run.prefills.append(Prefill(5.0, 5.01, 100, 128))
    _tick(run, 5.5)  # a prefill, but trace_s not yet run
    assert not run.trace.stopped
    _tick(run, 6.1)
    assert run.trace.stopped and run.slice_prefills == (0, 1)


def test_slice_without_a_prefill_runs_on(run):
    _tick(run, 4.0)
    for now in (6.1, 7.0, 9.9):
        _tick(run, now)
        assert not run.trace.stopped
    run.prefills.append(Prefill(9.95, 9.96, 100, 128))
    _tick(run, 9.97)
    assert run.trace.stopped and run.slice_prefills == (0, 1)


def test_slice_with_no_prefill_ends_at_the_close(run):
    _tick(run, 4.0)
    _tick(run, 9.99)
    assert not run.trace.stopped
    _tick(run, 10.0)
    assert run.trace.stopped and run.slice_prefills == (0, 0)


def test_prefills_before_the_slice_do_not_count(run):
    run.prefills.append(Prefill(1.0, 1.01, 100, 128))
    _tick(run, 4.0)
    _tick(run, 6.5)
    assert not run.trace.stopped and run.slice_prefills == (1, 1)
