"""The port's training step against the reference's jitted
``make_train_step`` (src/repro/train/step.py:60-134), two steps at 1 and
at 2 microbatches, at the float32 smoke configs of the seven families of
tests/test_torch_train.py, from the same weights and batches, mesh
(1, 1) as in tests/test_system.py.  The port passes the reference's
decay rule (``decay_by_rank``) so the two updates are the same function
(its own rule, ROADMAP C14, is pinned in tests/test_torch_train.py).

Tolerances: each step's loss within 1e-5 relative and ``lr`` exactly.
The parameters within 2 * lr absolute after the first step and 4 * lr
after the second: at step 1 AdamW's update is about +-1 for any gradient
near 0, so a sign flip at rounding level moves such an element by
2 * lr.  Both moments within 1e-4 of each leaf's largest magnitude after
the first step; after the second, which differentiates at parameters
that may hold such flips (and may route an MoE token elsewhere), within
1e-3.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from repro.models.params import init_params as ref_init  # noqa: E402
from repro.models.partitioning import make_rules  # noqa: E402
from repro.models.registry import get_smoke_config as ref_smoke  # noqa: E402
from repro.optim.adamw import adamw_init as ref_adamw_init  # noqa: E402
from repro.train.step import TrainHParams as RefHParams  # noqa: E402
from repro.train.step import make_train_step as ref_make_step  # noqa: E402

from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.models.registry import get_smoke_config  # noqa: E402
from repro_torch.optim.adamw import adamw_init, decay_by_rank  # noqa: E402
from repro_torch.train.step import TrainHParams, make_train_step  # noqa: E402

FAMILIES = [
    "paper-gpt2-124m", "granite-moe-1b-a400m", "gemma2-9b",
    "deepseek-v2-236b", "falcon-mamba-7b", "whisper-small", "internvl2-26b",
]
LR = 1e-3
LOSS_TOL = 1e-5
MOMENT_TOL = (1e-4, 1e-3)  # after steps 1 and 2
PARAM_ATOL = (2 * LR, 4 * LR)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _batch(cfg, i, b=4, s=32):
    rng = np.random.default_rng(100 + i)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.vision_prefix:
        out["vision_embeds"] = rng.normal(
            size=(b, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    if cfg.encoder_decoder:
        out["encoder_frames"] = rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _flat(tree, pre=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, pre + (k,)) if isinstance(v, dict)
                   else {pre + (k,): np.asarray(
                       v.detach() if torch.is_tensor(v) else v, np.float32)})
    return out


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_two_steps_match_the_reference(arch, mb, mesh):
    rc = dataclasses.replace(ref_smoke(arch), dtype="float32")
    pc = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    rules = make_rules(mesh, fsdp=rc.fsdp, n_heads=rc.n_heads,
                       n_kv_heads=rc.n_kv_heads)
    rp = ref_init(rc, jax.random.PRNGKey(3))
    pp = params_from_numpy(pc, jax.tree.map(np.asarray, rp), device="cpu")
    hp = dict(base_lr=LR, warmup_steps=1, total_steps=10,
              num_microbatches=mb)
    ref_step = jax.jit(ref_make_step(rc, rules, RefHParams(**hp)))
    step = make_train_step(pc, TrainHParams(**hp), decay=decay_by_rank(pp))
    ro, po = ref_adamw_init(rp), adamw_init(pp)
    for i in range(2):
        batch = _batch(rc, i)
        rp, ro, rm = ref_step(rp, ro, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        pp, po, m = step(pp, po, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                                 rel=LOSS_TOL), i
        assert float(m["lr"]) == float(rm["lr"])
        assert set(m) == set(rm)
        for k in set(m) - {"loss", "lr"}:
            assert float(m[k]) == pytest.approx(float(rm[k]), rel=LOSS_TOL,
                                                abs=1e-7), k
        assert int(po["step"]) == int(ro["step"]) == i + 1
        for name, ref, out in (("mu", ro["mu"], po["mu"]),
                               ("nu", ro["nu"], po["nu"])):
            r, o = _flat(jax.tree.map(np.asarray, ref)), _flat(out)
            for k in r:
                err = float(np.abs(o[k] - r[k]).max())
                assert err <= MOMENT_TOL[i] * max(
                    float(np.abs(r[k]).max()), 1e-30), (i, name, k, err)
        r, o = _flat(jax.tree.map(np.asarray, rp)), _flat(pp)
        for k in r:
            err = float(np.abs(o[k] - r[k]).max())
            assert err <= PARAM_ATOL[i], (i, k, err)
