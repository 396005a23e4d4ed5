"""Mamba's mixer and a decode's MoE over DTensors in a spawned 4-rank gloo
world on the CPU, against the same functions on plain tensors.

The world (``python tests/test_torch_mamba_sharded.py <dir>``, under
``subprocess.run(..., timeout=300)``, a FileStore rendezvous under the
test's temporary directory) lays jamba's float32 smoke weights out by
``param_pspecs`` on a (2, 2) mesh ("data", "model"), with and without
FSDP, and the inputs' batch over "data", as the model's sublayers get
them:

* ``mamba_forward`` in prefill, with ``last`` short of the sequence,
  then one decode step from its state, and in train: each rank keeps its
  own ``ssm_inner`` channels through the conv and the scan (ROADMAP
  C21).  The outputs, the prefill's ``conv``/``ssm`` state, the decoded
  state and the gradients of the input and of every weight for a seeded
  cotangent match the plain function's within 1e-5, relative and of
  each tensor's largest magnitude (at least 1);
* ``moe_forward`` on one token (a decode) with FSDP: each rank runs its
  own experts on its own ``embed`` slice and the stacks stay sharded
  (ROADMAP C22).  The output matches within 1e-5.

``roofline/op_counts.py``'s counter records every collective of those
calls: no all-gather carries a sequence-long activation (the (b, s,
d_inner) input the conv once gathered whole), and none is as large as
one expert's (d_model, d_ff_expert) matrix.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
ARCH = "jamba-v0.1-52b"
B, S, LAST = 4, 40, 29  # 40 rows: chunks of 16, 16 and 8
MAMBA_POS, MOE_POS = "pos0", "pos1"
TOL = 1e-5
FSDP = (False, True)


def _cfg(fsdp):
    from repro_torch.models.registry import get_smoke_config

    return dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                               fsdp=fsdp)


def _params(cfg):
    from repro_torch.models.params import init_params

    return init_params(cfg, torch.Generator().manual_seed(3), device="cpu")


def _inputs(cfg):
    rng = np.random.default_rng(5)
    d = cfg.d_model
    shapes = {"x": (B, S, d), "ct": (B, S, d), "x1": (B, 1, d)}
    return {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for n, s in shapes.items()}


def _layer(tree, pos, sub):
    return {k: v[0] for k, v in tree[pos][sub].items()}


def _mamba(p, x, cfg, rules=None):
    """Prefill at ``LAST``, a decode step from its state, and train with
    the gradients of x and every weight: a dict of tensors."""
    from repro_torch.models.layers import mamba_forward

    out = {}
    with torch.no_grad():
        y, st = mamba_forward(p, x["x"], cfg, mode="prefill",
                              last=torch.tensor([LAST]), rules=rules)
        out.update(prefill=y, conv=st["conv"], ssm=st["ssm"])
        cache = {k: v.clone() for k, v in st.items()}
        y, _ = mamba_forward(p, x["x1"], cfg, mode="decode", cache=cache,
                             rules=rules)
        out.update(decode=y, decode_conv=cache["conv"],
                   decode_ssm=cache["ssm"])
    names = sorted(p)
    leaves = [x["x"]] + [p[n] for n in names]
    y, _ = mamba_forward(p, x["x"], cfg, mode="train", rules=rules)
    grads = torch.autograd.grad((y * x["ct"]).sum(), leaves)
    out["train"] = y.detach()
    out.update({f"d_{n}": g for n, g in zip(["x"] + names, grads)})
    return out


def _moe(p, x, cfg, rules=None):
    from repro_torch.models.layers import moe_forward

    with torch.no_grad():
        return {"moe": moe_forward(p, x["x1"], cfg, mode="decode",
                                   rules=rules)[0]}


def _world(rank, world, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.params import param_pspecs
    from repro_torch.models.partitioning import (
        distribute_tree,
        is_dtensor,
        make_rules,
        replicated_ops,
    )
    from repro_torch.roofline.op_counts import OpCounter

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), world), world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        res, colls = {}, {}
        for fsdp in FSDP:
            cfg = _cfg(fsdp)
            rules = make_rules(mesh, fsdp=fsdp, n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads)
            params = distribute_tree(mesh, _params(cfg),
                                     param_pspecs(cfg, rules))
            x = _inputs(cfg)
            specs = {n: rules.spec_for(t.shape, ("batch",))
                     for n, t in x.items()}
            dx = distribute_tree(mesh, x, specs)
            dx["x"].requires_grad_(True)
            runs = [("mamba", _mamba, _layer(params, MAMBA_POS, "mamba"))]
            if fsdp:
                runs.append(("moe", _moe, _layer(params, MOE_POS, "moe")))
            for name, fn, p in runs:
                for t in p.values():
                    t.requires_grad_(name == "mamba")
                with replicated_ops(), OpCounter() as counter:
                    out = fn(p, dx, cfg, rules)
                colls[f"{name}_{fsdp}"] = counter.collectives
                for k, v in out.items():
                    v = v.full_tensor() if is_dtensor(v) else v
                    res[f"{name}_{fsdp}_{k}"] = v.detach().numpy()
        dist.barrier()
        if rank == 0:
            np.savez(tmp / "results.npz", **res)
            (tmp / "collectives.json").write_text(json.dumps(colls))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mamba_world")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, __file__, str(tmp)], capture_output=True,
        text=True, timeout=300, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(tmp / "results.npz") as z:
        res = {k: z[k] for k in z.files}
    return res, json.loads((tmp / "collectives.json").read_text())


def _plain(name, fsdp):
    cfg = _cfg(fsdp)
    params = _params(cfg)
    x = _inputs(cfg)
    if name == "moe":
        return _moe(_layer(params, MOE_POS, "moe"), x, cfg)
    p = {k: v.clone().requires_grad_(True)
         for k, v in _layer(params, MAMBA_POS, "mamba").items()}
    x["x"].requires_grad_(True)
    return _mamba(p, x, cfg)


CASES = [("mamba", f) for f in FSDP] + [("moe", True)]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{n}-{'fsdp' if f else 'tp'}" for n, f in CASES])
def test_sharded_layer_matches_the_plain_one(world, case):
    name, fsdp = case
    res, _ = world
    want = _plain(name, fsdp)
    for k, v in want.items():
        v = v.detach().numpy()
        # The shards sum the gradients' (b, s) terms in another order.
        scale = max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(res[f"{name}_{fsdp}_{k}"], v, rtol=TOL,
                                   atol=TOL * scale, err_msg=k)


def _gathers(colls):
    return [(nbytes, shape) for kind, nbytes, _, shape in colls
            if kind == "all-gather"]


@pytest.mark.parametrize("fsdp", FSDP, ids=["tp", "fsdp"])
def test_no_all_gather_carries_the_sequence(world, fsdp):
    # The conv on full values gathered the (b, s + d_conv - 1, d_inner)
    # input over both axes, and slicing in_proj's product gathered (b, s,
    # 2 d_inner): every such gather has a sequence-long dim.
    _, colls = world
    c = _cfg(fsdp)
    seq = {str(S), str(S + c.ssm.d_conv - 1)}
    long = [(n, sh) for n, sh in _gathers(colls[f"mamba_{fsdp}"])
            if seq & set(sh.split("[", 1)[1].rstrip("]").split(", "))]
    assert not long, long
    assert any(kind == "all-reduce" for kind, *_ in colls[f"mamba_{fsdp}"])


def test_no_all_gather_carries_an_expert_stack(world):
    _, colls = world
    c = _cfg(True)
    matrix = c.d_model * c.moe.d_ff_expert * 4  # one expert's w_in, f32
    big = [g for g in _gathers(colls["moe_True"]) if g[0] >= matrix]
    assert not big, big
    # The partial h and gate are reduced instead.
    assert any(kind == "all-reduce" for kind, *_ in colls["moe_True"])


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.spawn(_world, args=(WORLD, sys.argv[1]), nprocs=WORLD)
