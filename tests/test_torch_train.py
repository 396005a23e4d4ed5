"""Training in the port (ROADMAP A12): the train-mode forward, ``loss_fn``
and its gradients, the training step, the launcher and the example, held
against the JAX package.

The same weights (the reference's ``init_params``, carried over by
``params_from_numpy``) and the same numpy-seeded batch go through
``repro.models.model.loss_fn`` under ``jax.value_and_grad`` and through
the port's ``loss_fn`` under autograd, at the float32 smoke configs of
the seven families (dense gpt2, MoE granite, gemma2's window and
softcaps, deepseek-v2's MLA, falcon-mamba, whisper-small's encoder and
cross-attention, internvl2-26b's vision prefix), plus gemma2 at a vocab
of 500, whose padded columns the head masks under the logit softcap.
Tolerances: the loss and its parts within 1e-5 relative; every gradient
leaf within 1e-4 of the leaf's largest magnitude (float32; XLA-CPU and
aten reduce in different orders, worst seen 1.9e-5, jamba's Mamba scan).

Also: the port-only mirrors of tests/test_system.py's training tests and
tests/test_models_smoke.py's ``test_one_train_step``; train mode under
an installed session (no dispatch, no launch); remat against none;
AdamW's decay mask (ROADMAP C14) on both sides; the launcher and
``examples_torch/train_lm.py`` on the CPU, and the launcher's refusal
without a GPU.
"""
import dataclasses
import pathlib
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.params import init_params as ref_init  # noqa: E402
from repro.models.partitioning import AxisRules  # noqa: E402
from repro.models.registry import get_smoke_config as ref_smoke  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    decay_mask,
    init_params,
    params_from_numpy,
)
from repro_torch.models.registry import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig,
    adamw_init,
    adamw_update,
)
from repro_torch.train import step as train_step_mod  # noqa: E402
from repro_torch.train.step import TrainHParams, make_train_step  # noqa: E402
from repro_torch.vortex import Engine, use  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RULES = AxisRules(rules={}, mesh_axes=())
FAMILIES = [
    "paper-gpt2-124m", "granite-moe-1b-a400m", "gemma2-9b",
    "deepseek-v2-236b", "falcon-mamba-7b", "whisper-small", "internvl2-26b",
]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _configs(arch, **over):
    over = {"dtype": "float32", **over}
    return (dataclasses.replace(ref_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.vision_prefix:
        out["vision_embeds"] = rng.normal(
            size=(b, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    if cfg.encoder_decoder:
        out["encoder_frames"] = rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree, pre=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, pre + (k,)) if isinstance(v, dict)
                   else {pre + (k,): v})
    return out


def _ref_flat(tree):
    return {tuple(p.key for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _extras(batch):
    return {k: batch[k] for k in ("vision_embeds", "encoder_frames")
            if k in batch}


@pytest.mark.parametrize("arch,vocab", [(a, None) for a in FAMILIES]
                         + [("gemma2-9b", 500)])
def test_loss_and_grads_match_the_reference(arch, vocab):
    rc, pc = _configs(arch, **({"vocab": vocab} if vocab else {}))
    assert (pc.vocab_padded != pc.vocab) == bool(vocab)
    ref_params = ref_init(rc, jax.random.PRNGKey(0))
    params = params_from_numpy(pc, jax.tree.map(np.asarray, ref_params),
                               device="cpu")
    batch = _batch(rc, 2, 32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def ref_loss(p):
        return ref_model.loss_fn(rc, RULES, p, jb["tokens"], jb["labels"],
                                 **_extras(jb))

    (rl, rparts), rg = jax.value_and_grad(ref_loss, has_aux=True)(
        ref_params)
    flat = _flat(params)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    tb = _torch_batch(batch)
    loss, parts = model.loss_fn(pc, params, tb["tokens"], tb["labels"],
                                **_extras(tb))
    grads = torch.autograd.grad(loss, list(flat.values()))
    assert float(loss.detach()) == pytest.approx(float(rl), rel=LOSS_TOL)
    for k in ("xent", "aux", "dropped_frac"):
        assert float(parts[k].detach()) == pytest.approx(float(rparts[k]),
                                                rel=LOSS_TOL, abs=1e-7), k
    if pc.moe is not None:
        assert float(parts["aux"].detach()) > 0
    ref_grads = _ref_flat(rg)
    assert ref_grads.keys() == flat.keys()
    for key, g in zip(flat, grads):
        r = ref_grads[key]
        err = float(np.abs(g.numpy() - r).max())
        scale = float(np.abs(r).max())
        assert scale > 0 or key[-1] in ("conv_b",), (key, "zero gradient")
        assert err <= GRAD_TOL * max(scale, 1e-30), (key, err, scale)


def test_training_loss_decreases():
    """~60 steps on the GPT-2 smoke config must fit the synthetic stream
    (tests/test_system.py:36-54)."""
    cfg = get_smoke_config("paper-gpt2-124m")
    hp = TrainHParams(base_lr=1e-2, warmup_steps=10, total_steps=60,
                      num_microbatches=1)
    params, opt, step = launch_train.build_trainer(cfg, hp, device="cpu")
    data = SyntheticLMDataset(cfg.vocab, seq_len=32, global_batch=16)
    losses = []
    for i in range(60):
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 1.0, losses[::8]


def test_microbatch_accumulation_matches_full_batch():
    """num_microbatches=4 gives (numerically close) the update of one
    full batch (tests/test_system.py:57-80)."""
    cfg = get_smoke_config("paper-gpt2-124m")
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    data = SyntheticLMDataset(cfg.vocab, seq_len=16, global_batch=8)
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    outs = {}
    for mb in (1, 4):
        p = _clone(params)
        hp = TrainHParams(num_microbatches=mb, total_steps=10,
                          warmup_steps=1)
        p2, _, m = make_train_step(cfg, hp)(p, adamw_init(p), batch)
        assert p2 is p  # updated in place
        outs[mb] = (p2, float(m["loss"]))
    assert outs[1][1] == pytest.approx(outs[4][1], rel=2e-2)
    a, b = _flat(outs[1][0]), _flat(outs[4][0])
    for k in a:
        np.testing.assert_allclose(a[k].detach().float().numpy(),
                                   b[k].detach().float().numpy(),
                                   rtol=5e-2, atol=5e-3, err_msg=str(k))


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_train_step(arch):
    """One bf16 step of 2 microbatches on every smoke config: a finite
    positive loss, the step count at 1, and parameters that moved
    (tests/test_models_smoke.py:57-89)."""
    cfg = get_smoke_config(arch)
    hp = TrainHParams(num_microbatches=2, total_steps=10, warmup_steps=2)
    params, opt, step = launch_train.build_trainer(cfg, hp, seed=1,
                                                   device="cpu")
    before = _clone(params)
    batch = _torch_batch(_batch(cfg, 4, 32, seed=1), torch.bfloat16)
    params, opt, metrics = step(params, opt, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    assert int(opt["step"]) == 1
    assert any(not torch.equal(a, b) for a, b in
               zip(_flat(before).values(), _flat(params).values()))


@pytest.mark.parametrize("arch", ["paper-gpt2-124m", "granite-moe-1b-a400m",
                                  "whisper-small"])
def test_train_mode_dispatches_nothing_under_a_session(arch):
    """With an engine installed, a prefill dispatches its attention (and
    granite's experts) through it; the train-mode forward and backward
    dispatch nothing and launch no kernel: every op stays where autograd
    reaches it."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tb = _torch_batch(_batch(cfg, 2, 32))
    before = kernels.launch_counts()
    eng = Engine(device="cpu", hardware="tpu_v5e")
    with use(eng):
        for leaf in _flat(params).values():
            leaf.requires_grad_(True)
        loss, _ = model.loss_fn(cfg, params, tb["tokens"], tb["labels"],
                                **_extras(tb))
        loss.backward()
        assert [k for k in eng.stats() if k != "calibration"] == []
        with torch.no_grad():
            model.forward(cfg, params, tb["tokens"], mode="prefill",
                          cache_len=32, **_extras(tb))
    kinds = {k for k in eng.stats() if k != "calibration"}
    assert "attention" in kinds
    if cfg.moe is not None:
        assert "grouped_gemm" in kinds
    assert kernels.launch_counts() == before


def test_remat_changes_no_number():
    """Recomputing each group in the backward pass (``remat``, with the
    Mamba chunks checkpointed inside) gives the same loss and gradients
    as keeping every activation, bit for bit."""
    cfg = dataclasses.replace(get_smoke_config("jamba-v0.1-52b"),
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    tb = _torch_batch(_batch(cfg, 2, 32, seed=2))
    flat = list(_flat(params).values())
    for leaf in flat:
        leaf.requires_grad_(True)
    out = []
    for remat in (True, False):
        loss, _ = model.loss_fn(cfg, params, tb["tokens"], tb["labels"],
                                remat=remat)
        out.append((loss, torch.autograd.grad(loss, flat)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def _stacked_norm_paths(tree):
    return [k for k in _flat(tree) if k[0].startswith("pos")
            and k[-1] in ("norm_mixer", "norm_mlp")]


def test_reference_decays_stacked_norm_gains():
    """ROADMAP C14: the reference decays every leaf of rank >= 2
    (src/repro/optim/adamw.py:88-90), and stacking makes each layer's
    norm gains (n_groups, d): under a zero gradient they shrink by
    lr * weight_decay, while ``final_norm`` (d,) keeps its ones."""
    cfg = ref_smoke("paper-gpt2-124m")
    params = ref_init(cfg, jax.random.PRNGKey(0))
    zeros = jax.tree.map(jnp.zeros_like, params)
    new, _ = ref_adamw.adamw_update(
        ref_adamw.AdamWConfig(), params, zeros,
        ref_adamw.adamw_init(params), jnp.asarray(0.5))
    norms = _stacked_norm_paths(params)
    assert len(norms) == 2
    for path in norms:
        before = np.asarray(_get(params, path), np.float32)
        after = np.asarray(_get(new, path), np.float32)
        assert before.ndim == 2
        np.testing.assert_allclose(after, before * (1 - 0.5 * 0.1),
                                   rtol=1e-2)
    np.testing.assert_array_equal(np.asarray(new["final_norm"], np.float32),
                                  1.0)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ["paper-gpt2-124m", "falcon-mamba-7b",
                                  "whisper-small"])
def test_port_decays_only_per_layer_matrices(arch, monkeypatch):
    """The port's mask decides from each leaf's rank before stacking
    (``models.params.decay_mask``): under a zero gradient the matrices
    shrink by lr * weight_decay and every vector (norm gains, Mamba's
    conv_b, dt_bias and D) keeps its value; the train step passes this
    mask."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    mask = decay_mask(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat_mask = _flat(mask)
    before = _clone(params)
    ranks = {k: v.ndim for k, v in _flat(params).items()}
    grads = _tree_like(params, lambda t: torch.zeros_like(t))
    adamw_update(AdamWConfig(), params, grads, adamw_init(params),
                 torch.tensor(0.5), mask)
    b, a = _flat(before), _flat(params)
    vectors = {k for k, dec in flat_mask.items() if not dec}
    assert {("pos0", "norm_mixer"), ("final_norm",)} <= vectors
    if cfg.ssm is not None:
        assert {("pos0", "mamba", n) for n in ("conv_b", "dt_bias", "D")} \
            <= vectors
    for k, dec in flat_mask.items():
        stacked = k[0].startswith("pos") or k[:2] == ("encoder", "layers")
        assert dec == (ranks[k] - stacked >= 2), k
        if dec:
            torch.testing.assert_close(a[k], b[k] * (1 - 0.5 * 0.1))
        else:
            assert torch.equal(a[k], b[k]), k
    seen = []

    def spy(*args):
        seen.append(args[-1])
        return args[1], args[3]

    monkeypatch.setattr(train_step_mod, "adamw_update", spy)
    step = make_train_step(cfg, TrainHParams())
    step(params, adamw_init(params),
         _torch_batch(_batch(cfg, 2, 32), torch.float32))
    assert seen == [mask]


def _tree_like(tree, fn):
    return {k: _tree_like(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def test_launcher_runs_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu --steps
    3`` runs to the end, checkpoint included."""
    res = launch_train.main(["--smoke", "--device", "cpu", "--steps", "3",
                             "--ckpt-every", "2", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "failures=0 restores=0" in out
    assert len(res.history) == 3
    assert np.isfinite([loss for _, loss, _ in res.history]).all()


def test_launcher_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.build_trainer(get_smoke_config("paper-gpt2-124m"),
                                   TrainHParams())


def test_example_recovers_from_an_injected_failure(monkeypatch, capsys,
                                                   tmp_path):
    """examples_torch/train_lm.py --smoke --device cpu --fail-at 3: the
    supervisor restores the step-2 checkpoint and replays."""
    monkeypatch.setattr(sys, "argv", [
        "train_lm.py", "--smoke", "--device", "cpu", "--steps", "5",
        "--fail-at", "3", "--ckpt-every", "2",
        "--ckpt-dir", str(tmp_path)])
    runpy.run_path(str(ROOT / "examples_torch" / "train_lm.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "failures=1, restores=1" in out


def test_training_modules_load_no_jax(tmp_path):
    mods = ["repro_torch.launch.train", "repro_torch.train.step",
            "repro_torch.checkpoint.manager", "repro_torch.data.pipeline",
            "repro_torch.optim", "repro_torch.runtime.supervisor",
            "repro_torch.runtime.heartbeat"]
    code = (
        f"import sys, importlib; [importlib.import_module(m) for m in "
        f"{mods!r}]; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": "/usr/bin:/bin"},
        timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
