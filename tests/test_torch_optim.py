"""The port's optimizer, schedule and gradient compression
(src/repro_torch/optim/), mirroring tests/test_optim.py (its ZeRO-1
pspec test waits for the mesh) and held against ``repro.optim`` on the
same arrays.

Tolerances: ``adamw_update``'s parameters and moments within 1e-6 of the
reference relative to each leaf's largest magnitude (float32, the same
op order; the two libraries' ``pow`` and ``sqrt`` may differ in the last
ulp), the schedule within 1e-6 relative, and the int8 codes equal.
"""
import numpy as np
import pytest
import torch

from conftest import optional_hypothesis

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import compression as ref_comp  # noqa: E402
from repro.optim import schedule as ref_sched  # noqa: E402

from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig,
    adamw_init,
    adamw_update,
    decay_by_rank,
    global_norm,
)
from repro_torch.optim.compression import (  # noqa: E402
    compress_int8,
    decompress_int8,
    ef_compress_update,
)
from repro_torch.optim.schedule import (  # noqa: E402
    cosine_schedule,
    linear_warmup_cosine,
)

given, settings, st = optional_hypothesis()

TOL = 1e-6


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = adamw_init(params)
    cfg = AdamWConfig(weight_decay=0.0)
    for _ in range(200):
        g = {"w": 2.0 * (params["w"] - 1.0)}
        params, opt = adamw_update(cfg, params, g, opt, torch.tensor(0.1))
    np.testing.assert_allclose(params["w"].numpy(), 1.0, atol=1e-2)
    assert int(opt["step"]) == 200


def test_adamw_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    opt = adamw_init(params)
    cfg = AdamWConfig(grad_clip=1.0, weight_decay=0.0)
    huge = {"w": torch.full((4,), 1e9)}
    p2, _ = adamw_update(cfg, params, huge, opt, torch.tensor(0.1))
    # First-step Adam update magnitude is ~lr regardless of gradient scale.
    assert float(p2["w"].abs().max()) < 0.2


def test_warmup_then_decay():
    lrs = [float(linear_warmup_cosine(torch.tensor(s), 1.0, 10, 100))
           for s in range(100)]
    assert lrs[0] < lrs[5] < lrs[9]          # warming up
    assert lrs[20] > lrs[50] > lrs[99]       # decaying
    assert lrs[99] >= 0.1 - 1e-6             # floor


def test_schedules_match_the_reference():
    for step in range(0, 130, 3):
        for warm, total in ((10, 100), (1, 10), (5, 50), (100, 10000)):
            ref = float(ref_sched.linear_warmup_cosine(
                jnp.asarray(step, jnp.int32), 3e-4, warm, total))
            out = float(linear_warmup_cosine(
                torch.tensor(step, dtype=torch.int32), 3e-4, warm, total))
            assert out == pytest.approx(ref, rel=TOL), (step, warm, total)
        ref = float(ref_sched.cosine_schedule(jnp.asarray(step), 1.0, 100))
        assert float(cosine_schedule(torch.tensor(step), 1.0, 100)) == \
            pytest.approx(ref, rel=TOL)


def _tree(rng, dtype):
    return {
        "w": rng.normal(size=(6, 5)).astype(dtype),
        "stack": {"g": rng.normal(size=(3, 5)).astype(dtype),
                  "b": rng.normal(size=(5,)).astype(dtype)},
    }


def _flat(tree, pre=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, pre + (k,)) if isinstance(v, dict)
                   else {pre + (k,): np.asarray(v, np.float32)})
    return out


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _close(out, ref, where):
    o, r = _flat(out), _flat(ref)
    assert o.keys() == r.keys()
    for k in r:
        err = float(np.abs(o[k] - r[k]).max())
        assert err <= TOL * max(float(np.abs(r[k]).max()), 1.0), (where, k,
                                                                  err)


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_the_reference(clip):
    """Three steps on the same float32 arrays, with clipping active and
    not, the reference's decay rule (rank >= 2): parameters, both moments
    and the step count agree."""
    rng = np.random.default_rng(0)
    cfg_r = ref_adamw.AdamWConfig(grad_clip=clip)
    cfg_t = AdamWConfig(grad_clip=clip)
    params = _tree(rng, np.float32)
    rp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    ro, to = ref_adamw.adamw_init(rp), adamw_init(tp)
    for i in range(3):
        g = _tree(rng, np.float32)
        lr = 1e-2 * (i + 1)
        rp, ro = ref_adamw.adamw_update(
            cfg_r, rp, jax.tree.map(jnp.asarray, g), ro, jnp.asarray(lr))
        tp, to = adamw_update(cfg_t, tp, _to_torch(g), to,
                              torch.tensor(lr), decay_by_rank(tp))
    _close(tp, rp, "params")
    _close(to["mu"], ro["mu"], "mu")
    _close(to["nu"], ro["nu"], "nu")
    assert int(to["step"]) == int(ro["step"]) == 3
    assert float(global_norm(_to_torch(g))) == pytest.approx(
        float(ref_adamw.global_norm(jax.tree.map(jnp.asarray, g))), rel=TOL)


def test_adamw_update_on_bf16_rounds_once():
    """bf16 parameters: the update runs in float32 and is cast once, as
    the reference's; the moments stay float32."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(8, 8)).astype(np.float32)
    g = rng.normal(size=(8, 8)).astype(np.float32)
    rp = {"w": jnp.asarray(w, jnp.bfloat16)}
    tp = {"w": torch.tensor(w).to(torch.bfloat16)}
    rp, ro = ref_adamw.adamw_update(
        ref_adamw.AdamWConfig(), rp, {"w": jnp.asarray(g, jnp.bfloat16)},
        ref_adamw.adamw_init(rp), jnp.asarray(3e-4))
    tp, to = adamw_update(AdamWConfig(), tp,
                          {"w": torch.tensor(g).to(torch.bfloat16)},
                          adamw_init(tp), torch.tensor(3e-4))
    assert tp["w"].dtype == torch.bfloat16
    assert to["mu"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["w"].float().numpy(), np.asarray(rp["w"], np.float32))


def test_decay_mask_selects_the_decayed_leaves():
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    opt = adamw_init(params)
    zero = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    cfg = AdamWConfig(weight_decay=0.5)
    params, _ = adamw_update(cfg, params, zero, opt, 0.1,
                             {"w": False, "b": True})
    assert torch.equal(params["w"], torch.ones(2, 2))
    torch.testing.assert_close(params["b"], torch.full((2,), 0.95))


@given(
    scale=st.floats(1e-6, 1e6),
    seed=st.integers(0, 2**16),
)
@settings(max_examples=40, deadline=None)
def test_int8_roundtrip_error_bound(scale, seed):
    """Each element within half a quantization step, up to float32's
    rounding of ``x / scale`` (the bound tests/test_optim.py states leaves
    none, ROADMAP "Known flaky reference test")."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(256,)) * scale, dtype=torch.float32)
    q, s = compress_int8(x)
    back = decompress_int8(q, s)
    step = float(s)
    assert float((back - x).abs().max()) <= 0.5 * step * (1 + 1e-5) + 1e-12
    assert q.dtype == torch.int8


def test_int8_codes_match_the_reference():
    rng = np.random.default_rng(3)
    for scale in (1e-4, 1.0, 1e4):
        x = (rng.normal(size=(512,)) * scale).astype(np.float32)
        q, s = compress_int8(torch.tensor(x))
        rq, rs = ref_comp.compress_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
        np.testing.assert_array_equal(
            decompress_int8(q, s).numpy(),
            np.asarray(ref_comp.decompress_int8(rq, rs)))


def test_error_feedback_is_unbiased_over_time():
    """With error feedback the sum of compressed gradients tracks the sum
    of true gradients (the residual never grows), and every step's output
    equals the reference's."""
    rng = np.random.default_rng(0)
    err = torch.zeros(64)
    rerr = jnp.zeros((64,), jnp.float32)
    true_sum = np.zeros((64,))
    sent_sum = np.zeros((64,))
    for _ in range(50):
        g = rng.normal(size=(64,)).astype(np.float32)
        q, _, err, approx = ef_compress_update(torch.tensor(g), err)
        rq, _, rerr, _ = ref_comp.ef_compress_update(jnp.asarray(g), rerr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        true_sum += g
        sent_sum += approx.numpy()
    resid = np.abs(true_sum - sent_sum)
    np.testing.assert_allclose(resid, np.abs(err.numpy()), atol=1e-4)
    np.testing.assert_allclose(err.numpy(), np.asarray(rerr), atol=1e-6)
    assert resid.max() < 1.0
