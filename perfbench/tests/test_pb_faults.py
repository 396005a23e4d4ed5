"""A run driven on the CPU (the harness's look for a chip skipped, the
port's plain versions at the smoke sizes) with the timed path broken
underneath: ``correct`` must come out false for each fault a cell can
have.  The cells run on one chip, so no exchange between chips exists to
leave out.  The sound run beside them comes out true."""
import json
import os
import time
import types

import pytest
import torch

from kit import runner, spec

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _json(name):
    with open(os.path.join(HERE, "data", name + ".json")) as f:
        return json.load(f)


def _cell(conf, mix, settings):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return spec.Cell(name="cpu-test", chips=1, conf=_json(conf),
                     mix=_json(mix), settings=_json(settings),
                     end_to_end=[m for m in bench["end_to_end"]
                                 if m["name"] == "setup_s"], per_layer=[])


def _run(cell, seed=2147483693, seconds=2.0, control=0):
    torch.set_num_threads(2)
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0,
                                 rate=None, control=control, dump=None)
    return runner.run(cell, args, time.perf_counter(), device="cpu")


def _serve_cell(model):
    return _cell(model, "chat-smoke", "serve-smoke-cell")


# -- serving faults, planted in the port ------------------------------------

def _state_unchanged(monkeypatch):
    """A decode step that leaves the cache as it was: the new token's k/v
    rows are never written."""
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "_write_rows", lambda *a, **k: None)


def _half_batch(monkeypatch):
    """Every other row of a step left out: its logits are the mean of the
    rows computed."""
    from repro_torch.launch.serve import VortexServer

    real = VortexServer.decode_vec

    def decode_vec(self, cache, tokens, pos):
        logits = real(self, cache, tokens, pos)
        logits[1::2] = logits[0::2].float().mean(0).to(logits.dtype)
        return logits

    monkeypatch.setattr(VortexServer, "decode_vec", decode_vec)


def _token_altered(monkeypatch):
    """One row's token changed where it is produced, every fifth step."""
    from repro_torch.launch.serve import VortexServer

    real = VortexServer.decode_vec
    count = [0]

    def decode_vec(self, cache, tokens, pos):
        logits = real(self, cache, tokens, pos)
        count[0] += 1
        if count[0] % 5 == 0:
            i = int(logits[0, :self.cfg.vocab].argmin())
            logits[0, i] = 1e4
        return logits

    monkeypatch.setattr(VortexServer, "decode_vec", decode_vec)


SERVE_FAULTS = [_state_unchanged, _half_batch, _token_altered]


def test_sound_serving_run_is_correct():
    res = _run(_serve_cell("phi4-smoke"))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("model", ["phi4-smoke", "granite-smoke"])
@pytest.mark.parametrize("fault", SERVE_FAULTS, ids=lambda f: f.__name__)
def test_serving_fault_is_caught(model, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(_serve_cell(model))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("model", ["phi4-smoke", "granite-smoke"])
def test_serving_control_in_the_programs_place_is_not_correct(model):
    res = _run(_serve_cell(model), control=1)
    assert res["correct"] is False, res["checks"]
    assert res["program_correct"] is True, res["notes"]


# -- GEMM stream faults -----------------------------------------------------

class _Broken:
    """``vortex.ops.gemm`` with its answer broken after it is made."""

    def __init__(self, real, how):
        self._real, self._how = real, how

    def __call__(self, a, b):
        out = self._real(a, b)
        self._how(out)
        return out

    def __getattr__(self, name):
        return getattr(self._real, name)


def _half_rows(out):
    m = out.shape[0]
    if m > 1:
        out[m // 2:] = out[:m // 2].float().mean(0).to(out.dtype)


def _answer_altered(out):
    out[out.shape[0] // 2, 0] += 1.0


def _gemm_cell():
    return _cell("phi4-smoke", "gemm-smoke", "gemm-smoke-cell")


def test_sound_gemm_run_is_correct():
    res = _run(_gemm_cell(), seconds=1.0)
    assert res["correct"], res["checks"]


def test_gemm_control_in_the_programs_place_is_not_correct():
    res = _run(_gemm_cell(), seconds=1.0, control=1)
    assert res["correct"] is False, res["checks"]
    assert res["program_correct"] is True, res["notes"]


@pytest.mark.parametrize("how", [_half_rows, _answer_altered],
                         ids=lambda f: f.__name__)
def test_gemm_fault_is_caught(how, monkeypatch):
    from repro_torch.vortex import ops

    monkeypatch.setattr(ops, "gemm", _Broken(ops.gemm, how))
    res = _run(_gemm_cell(), seconds=1.0)
    assert not res["correct"], res["checks"]
