"""The families beyond the dense and MoE decoders of
tests/test_torch_distributed.py under a (2, 2) mesh: the sharded loss
and every gradient against the JAX package's ``jax.value_and_grad``, on
the same weights and numpy batch.

One spawned world of 4 gloo ranks (``python
tests/test_torch_distributed_families.py <dir>``, under
``subprocess.run(..., timeout=300)``; FileStore rendezvous under the
test's temporary directory) runs ``loss_fn`` over DTensor parameters
laid out by ``param_pspecs`` (each config's ``fsdp``) and a batch
sharded over "data", with the model's sharding constraints:
deepseek-v2-236b (MLA, its FSDP expert stacks gathered on "embed"),
falcon-mamba-7b (the depthwise conv on full values), whisper-small
(encoder and cross-attention) and internvl2-26b (the vision prefix).
Rank 0 writes the loss, its parts and the full gradients.  Tolerances as tests/test_torch_train.py's: the loss
and its parts within 1e-5 relative, every gradient leaf within 1e-4 of
the leaf's largest magnitude (float32; the two packages and the shards
reduce in different orders).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
FAMILIES = ("deepseek-v2-236b", "falcon-mamba-7b", "whisper-small",
            "internvl2-26b")
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
SEP = "|"


def _batch(cfg, b=4, s=32):
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int64),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)}
    if cfg.vision_prefix:
        out["vision_embeds"] = rng.normal(
            size=(b, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    if cfg.encoder_decoder:
        out["encoder_frames"] = rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        key = f"{pre}{SEP}{k}" if pre else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split(SEP)
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _world(rank, world, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.models.model import loss_fn
    from repro_torch.models.params import param_pspecs, params_from_numpy
    from repro_torch.models.partitioning import (
        distribute_tree,
        make_rules,
        replicated_ops,
    )
    from repro_torch.models.registry import get_config, get_smoke_config
    from repro_torch.train.step import shard_batch

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), world), world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with np.load(tmp / "inputs.npz") as z:
            inputs = {k: z[k] for k in z.files}
        res = {}
        for arch in FAMILIES:
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      dtype="float32",
                                      fsdp=get_config(arch).fsdp)
            rules = make_rules(mesh, fsdp=cfg.fsdp, n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads)
            flat = {k.split(SEP, 1)[1]: v for k, v in inputs.items()
                    if k.startswith(arch + SEP)}
            params = distribute_tree(
                mesh, params_from_numpy(cfg, _nest(flat), device="cpu"),
                param_pspecs(cfg, rules))
            leaves = _flat(params)
            for p in leaves.values():
                p.requires_grad_(True)
            batch = shard_batch({k: torch.from_numpy(v)
                                 for k, v in _batch(cfg).items()}, rules)
            extras = {k: batch[k] for k in ("vision_embeds",
                                            "encoder_frames") if k in batch}
            with replicated_ops():
                loss, parts = loss_fn(cfg, params, batch["tokens"],
                                      batch["labels"], rules=rules, **extras)
                grads = torch.autograd.grad(loss, list(leaves.values()))
            for k, v in {"loss": loss, **parts}.items():
                v = v.detach()
                res[f"{arch}{SEP}{k}"] = np.array(float(
                    v.full_tensor() if isinstance(v, DTensor) else v))
            for k, g in zip(leaves, grads):
                res[f"{arch}{SEP}grad{SEP}{k}"] = g.full_tensor().numpy()
        dist.barrier()
        if rank == 0:
            np.savez(tmp / "results.npz", **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the world's results, the reference's weights per arch)."""
    jax = pytest.importorskip("jax")
    from repro.models.params import init_params as ref_init
    from repro.models.registry import get_smoke_config as ref_smoke

    tmp = tmp_path_factory.mktemp("families")
    inputs, weights = {}, {}
    for arch in FAMILIES:
        rc = dataclasses.replace(ref_smoke(arch), dtype="float32")
        weights[arch] = ref_init(rc, jax.random.PRNGKey(0))
        inputs.update({f"{arch}{SEP}{k}": v for k, v in
                       _flat(jax.tree.map(np.asarray, weights[arch])).items()})
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, __file__, str(tmp)], capture_output=True,
        text=True, timeout=300, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(tmp / "results.npz") as z:
        return {k: z[k] for k in z.files}, weights


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_loss_and_grads_match_the_reference(world, arch):
    import jax
    import jax.numpy as jnp
    from repro.models import model as ref_model
    from repro.models.partitioning import AxisRules
    from repro.models.registry import get_smoke_config as ref_smoke

    res, weights = world
    rc = dataclasses.replace(ref_smoke(arch), dtype="float32")
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in _batch(rc).items()}
    extras = {k: jb[k] for k in ("vision_embeds", "encoder_frames")
              if k in jb}

    def ref_loss(p):
        return ref_model.loss_fn(rc, AxisRules(rules={}, mesh_axes=()), p,
                                 jb["tokens"], jb["labels"], **extras)

    (rl, rparts), rg = jax.value_and_grad(ref_loss, has_aux=True)(
        weights[arch])
    assert float(res[f"{arch}{SEP}loss"]) == pytest.approx(float(rl),
                                                          rel=LOSS_TOL)
    for k in ("xent", "aux", "dropped_frac"):
        assert float(res[f"{arch}{SEP}{k}"]) == pytest.approx(
            float(rparts[k]), rel=LOSS_TOL, abs=1e-7), k
    ref_grads = _flat(jax.tree.map(np.asarray, rg))
    got = {k.split(SEP, 2)[2]: v for k, v in res.items()
           if k.startswith(f"{arch}{SEP}grad{SEP}")}
    assert got.keys() == ref_grads.keys()
    for k, r in ref_grads.items():
        err = float(np.abs(got[k] - r).max())
        scale = float(np.abs(r).max())
        assert err <= GRAD_TOL * max(scale, 1e-30), (k, err, scale)


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.spawn(_world, args=(WORLD, sys.argv[1]), nprocs=WORLD)
