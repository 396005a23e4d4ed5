"""``chunked_attention`` over DTensors (kernels/ref.py ``_on_local_heads``)
in a spawned 4-rank gloo world on the CPU, against the same function on
plain tensors.

The world (``python tests/test_torch_attention_sharded.py <dir>``, under
``subprocess.run(..., timeout=300)``, a FileStore rendezvous under the
test's temporary directory) lays q, K and V out on a (2, 2) mesh
("data", "model") by the rules of ``make_rules(n_heads=, n_kv_heads=)``:
the batch over "data", the heads over "model" where they divide it.
Keys run past the chunk, so the chunked loop runs on each rank's
shard, forward and backward.  Three head layouts:

* 4 q heads over 2 kv heads: both divide the model axis;
* 4 q heads over 1 kv head: K/V replicated on it while q's heads are
  sharded (the layout whose backward failed, ROADMAP C17);
* 3 q heads over 1 kv head: nothing divides, every rank runs every head.

Each case is causal, with a window and a softcap.  The output and the
gradients of q, K and V for a seeded cotangent match the plain
function's within 1e-5 (float32, the same loop on a slice of the rows).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
B, SQ, D, CHUNK = 4, 40, 8, 16
CASES = ((4, 2), (4, 1), (3, 1))  # (q heads, kv heads)
KW = dict(causal=True, window=24, softcap=20.0, chunk=CHUNK)


def _inputs(hq, hkv):
    rng = np.random.default_rng(hq * 10 + hkv)
    shapes = {"q": (B, hq, SQ, D), "k": (B, hkv, SQ, D),
              "v": (B, hkv, SQ, D), "ct": (B, hq, SQ, D)}
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}


def _attend(x, rules=None):
    from repro_torch.kernels.ref import chunked_attention

    out = chunked_attention(x["q"], x["k"], x["v"], rules=rules, **KW)
    grads = torch.autograd.grad(out, [x["q"], x["k"], x["v"]], x["ct"])
    return out, grads


def _world(rank, world, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.partitioning import (
        distribute_tree,
        make_rules,
        replicated_ops,
    )

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), world), world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        res = {}
        for hq, hkv in CASES:
            rules = make_rules(mesh, n_heads=hq, n_kv_heads=hkv)
            x = {n: torch.from_numpy(a) for n, a in _inputs(hq, hkv).items()}
            specs = {"q": rules.spec_for(x["q"].shape, ("batch",)),
                     "k": rules.spec_for(x["k"].shape, ("batch",)),
                     "v": rules.spec_for(x["v"].shape, ("batch",)),
                     "ct": rules.spec_for(x["ct"].shape,
                                          ("batch", "heads_act"))}
            dx = distribute_tree(mesh, x, specs)
            for n in ("q", "k", "v"):
                dx[n].requires_grad_(True)
            with replicated_ops():
                out, grads = _attend(dx, rules)
            name = f"{hq}_{hkv}"
            res[f"{name}_out"] = out.full_tensor().detach().numpy()
            for n, g in zip("qkv", grads):
                res[f"{name}_d{n}"] = g.full_tensor().numpy()
        dist.barrier()
        if rank == 0:
            np.savez(tmp / "results.npz", **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("attn_world")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, __file__, str(tmp)], capture_output=True,
        text=True, timeout=300, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(tmp / "results.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", CASES, ids=[f"{h}q_{k}kv" for h, k in CASES])
def test_sharded_chunked_attention_matches_the_plain_one(world, case):
    hq, hkv = case
    x = {n: torch.from_numpy(a) for n, a in _inputs(hq, hkv).items()}
    for n in ("q", "k", "v"):
        x[n].requires_grad_(True)
    out, grads = _attend(x)
    name = f"{hq}_{hkv}"
    np.testing.assert_allclose(world[f"{name}_out"], out.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for n, g in zip("qkv", grads):
        np.testing.assert_allclose(world[f"{name}_d{n}"], g.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=n)


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.spawn(_world, args=(WORLD, sys.argv[1]), nprocs=WORLD)
