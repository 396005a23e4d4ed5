"""The frozen float32 reference against the port's plain torch forward
(``prefill_step``/``decode_step`` with no engine installed) at the smoke
sizes, in float32, on the same harness-made weights: prefill logits at
each prompt's last token, then decode logits through the cache with the
rows at mixed positions.  So the reference is shown right before it
judges the chip."""
import dataclasses
import json
import os

import pytest
import torch

from kit import weights
from reference import decoder

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke(name):
    with open(os.path.join(HERE, "data", name + ".json")) as f:
        conf = json.load(f)
    model = dict(conf["model"], dtype="float32")
    return conf, model


@pytest.mark.parametrize("name", ["granite-smoke", "phi4-smoke"])
def test_reference_matches_port_prefill_and_mixed_decode(name):
    from repro_torch.models.model import decode_step, prefill_step
    from repro_torch.models.registry import get_smoke_config

    conf, model = _smoke(name)
    cfg = dataclasses.replace(get_smoke_config(conf["port_config"]),
                              dtype="float32")
    params = weights.draw(model, 7, "cpu")
    gen = torch.Generator().manual_seed(3)
    lens, sp, kvb, steps = [5, 11, 16], 16, 32, 4
    prompts = [torch.randint(0, model["vocab"], (s,), generator=gen)
               for s in lens]
    caches, tol = [], 1e-4
    for p in prompts:
        toks = torch.zeros((1, sp), dtype=torch.int64)
        toks[0, :p.numel()] = p
        logits, cache, _ = prefill_step(cfg, params, toks, cache_len=kvb,
                                        last=p.numel() - 1)
        ref = decoder.logits(params, model, p, p.numel(), sp)
        got = logits[0, :model["vocab"]]
        assert (got - ref[0]).abs().max() < tol * ref.abs().max()
        caches.append(cache)
    cache = {k: {n: torch.cat([c[k][n] for c in caches], dim=1)
                 for n in caches[0][k]} for k in caches[0]}
    fed = torch.randint(0, model["vocab"], (len(lens), steps), generator=gen)
    pos = torch.tensor(lens, dtype=torch.int32)
    outs = []
    for t in range(steps):
        logits, cache, _ = decode_step(cfg, params, cache, fed[:, t:t + 1],
                                       pos + t)
        outs.append(logits[:, :model["vocab"]])
    for i, p in enumerate(prompts):
        seq = torch.cat([p, fed[i]])
        ref = decoder.logits(params, model, seq, p.numel(), sp)
        for t in range(steps):
            got, want = outs[t][i], ref[t + 1]
            assert (got - want).abs().max() < tol * want.abs().max(), (i, t)


def test_control_is_coarser_than_the_reference():
    conf, model = _smoke("phi4-smoke")
    params = weights.draw(model, 7, "cpu")
    toks = torch.randint(0, model["vocab"], (40,),
                         generator=torch.Generator().manual_seed(0))
    ref = decoder.logits(params, model, toks, 10, 16)
    low = decoder.logits(params, model, toks, 10, 16, weight_fmt="fp8")
    err = (low - ref).abs().max() / ref.abs().max()
    assert 1e-3 < err < 0.5


def test_moe_capacity_drops_in_the_prompt_group_only():
    _, model = _smoke("granite-smoke")
    model = dict(model, moe=dict(model["moe"], capacity_factor=0.25))
    params = weights.draw(model, 1, "cpu")
    x = torch.randn(12, model["d_model"],
                    generator=torch.Generator().manual_seed(1))
    p = {n: w[0] for n, w in params["pos0"]["moe"].items()}
    # C = ceil(16 * 2 * 0.25 / 4) = 2 per expert over the 10 prompt tokens.
    tight = decoder.moe(x, p, model, 10, 16, "f32")
    loose = decoder.moe(x, p, dict(model, moe=dict(
        model["moe"], capacity_factor=100.0)), 10, 16, "f32")
    assert not torch.allclose(tight[:10], loose[:10])
    assert torch.allclose(tight[10:], loose[10:])
