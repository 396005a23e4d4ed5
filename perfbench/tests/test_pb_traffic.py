"""The traffic generator: the same seed gives the same work, every seed
the same multiset of sizes and gaps."""
import json
import os

import numpy as np
import pytest

from kit import traffic

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(PB, "tests", "data")


def _mix(name):
    with open(os.path.join(PB, "traffic", name + ".json")) as f:
        return json.load(f)


def _open_mix():
    """An open-loop mix of two classes (no cell runs one yet)."""
    with open(os.path.join(DATA, "chat-smoke.json")) as f:
        return json.load(f)


def _sig(items):
    return [(it.due, it.cls, it.max_new, it.tokens.tobytes()) for it in items]


def test_open_loop_is_deterministic_by_seed():
    mix = _open_mix()
    a = traffic.open_loop(mix, 20.0, 200064, 2147483701)
    b = traffic.open_loop(mix, 20.0, 200064, 2147483701)
    c = traffic.open_loop(mix, 20.0, 200064, 2147483702)
    assert _sig(a) == _sig(b)
    assert _sig(a) != _sig(c)


def test_open_loop_same_work_for_every_seed():
    mix = _open_mix()
    runs = [traffic.open_loop(mix, 30.0, 200064, s) for s in (1, 2, 2**31 + 7)]
    n = round(mix["rate_per_s"] * 30.0)
    for items in runs:
        assert len(items) == n
        assert abs(items[-1].due - 30.0) < 1e-9
        dues = [it.due for it in items]
        assert dues == sorted(dues)
        assert sum(it.cls == "doc" for it in items) == round(0.2 * n)
    lens = [sorted(it.tokens.shape[1] for it in items) for items in runs]
    outs = [sorted(it.max_new for it in items) for items in runs]
    gaps = [sorted(np.round(np.diff([0.0] + [it.due for it in items]), 9))
            for items in runs]
    assert lens[0] == lens[1] == lens[2]
    assert outs[0] == outs[1] == outs[2]
    assert gaps[0] == gaps[1] == gaps[2]


def test_lengths_stay_in_their_clips():
    mix = _open_mix()
    for it in traffic.open_loop(mix, 51.0, 200064, 5):
        c = next(c for c in mix["classes"] if c["name"] == it.cls)
        s = it.tokens.shape[1]
        assert c["prompt"]["min"] <= s <= c["prompt"]["max"]
        assert c["output"]["min"] <= it.max_new <= c["output"]["max"]
        assert it.tokens.min() >= 0 and it.tokens.max() < 200064


def test_closed_loop_and_gemm_rows_are_deterministic():
    mix = _mix("batch64")
    assert _sig(traffic.closed_loop(mix, 50, 49155, 9)) == \
        _sig(traffic.closed_loop(mix, 50, 49155, 9))
    g = _mix("gemm_stream")
    a = traffic.gemm_rows(g, 3, 4)
    assert (a == traffic.gemm_rows(g, 3, 4)).all()
    cyc = g["cycle"]
    # Every cycle is the same multiset in its own order.
    assert sorted(a[:cyc]) == sorted(a[cyc:2 * cyc]) == sorted(
        traffic.gemm_rows(g, 1, 99))
    assert a.min() >= g["m_min"] and a.max() <= g["m_max"]


def test_lognormal_quantiles_are_centered():
    d = {"dist": "lognormal", "median": 512, "sigma": 0.8, "min": 32,
         "max": 2048}
    v = traffic.stratified(d, 1001, np.random.default_rng(0))
    assert int(np.median(v)) == 512


@pytest.mark.parametrize("name", ["batch64", "gemm_stream"])
def test_every_mix_names_its_source(name):
    mix = _mix(name)
    assert mix["source"] and mix["fit"]


def test_batch_lengths_keep_the_published_means():
    """ShareGPT's published means (161.31 prompt, 337.99 output tokens)
    survive the clip, over a closed loop's whole pool."""
    mix = _mix("batch64")
    items = traffic.closed_loop(mix, 4096, 49155, 2147483811)
    prompts = np.mean([it.tokens.shape[1] for it in items])
    outs = np.mean([it.max_new for it in items])
    assert prompts == pytest.approx(161.31, rel=0.02)
    assert outs == pytest.approx(337.99, rel=0.02)
