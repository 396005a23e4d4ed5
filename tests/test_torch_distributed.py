"""The port's distribution layer in spawned multi-rank worlds on the CPU
(gloo), against the JAX package on the same numpy inputs.

One world of 4 ranks (``python tests/test_torch_distributed.py <dir>``,
run under ``subprocess.run(..., timeout=300)``; the rendezvous is a
FileStore under the test's temporary directory, so concurrent test
workers never share a port) runs every check and rank 0 writes the
results; the tests compare them with the reference:

* ``flash_decode_sharded`` on a (2, 2) mesh, the cache sharded over
  ("data", "model") on its batch and sequence axes, for the four
  (pos, window) cases of tests/test_flash_decode_multidev.py, against the
  reference's dense ``_decode_attend`` within rtol/atol 2e-4 as there; the
  cache writes exact (the owning rank writes its row, no other row moves);
* ``decode_step`` through the sequence-sharded branch on a (1, 4) mesh
  (starcoder2's smoke config: 2 kv heads do not divide 4) against the
  plain decode, and a per-row ``pos`` refused with ``PerRowPosError``;
  ``VortexServer`` refusing the (2, 2) mesh (``MeshServingError``);
* two sharded train steps of 2 microbatches on a (2, 2) mesh, float32
  smoke configs from the reference's weights, for paper-gpt2 (dense),
  starcoder2 (FSDP: ``embed`` over "data") and granite (EP: experts over
  "model"; its gradients pinned to the ZeRO-1 layout through
  ``grad_pspecs``), against the jitted unsharded reference step.
  Tolerances as tests/test_torch_train_step.py's: each step's loss within
  1e-5 relative and ``lr`` exactly; parameters within 2 * lr absolute
  after step 1 and 4 * lr after step 2; both moments within 1e-4 (step 1)
  and 1e-3 (step 2) of each leaf's largest magnitude.  The ZeRO-1
  moments' local shards are the sharded size;
* a checkpoint saved from the (2, 2) world restored onto the (1, 2) mesh
  that ``plan_remesh`` gives for 2 surviving chips: every value exact;
* the Supervisor over a DTensor state: an asynchronous save whose write
  rank 0 holds back, then a planted failure, restores the same step on
  every rank; a write that fails on rank 0 raises on every rank.

C15: the reference's ``flash_decode_sharded`` with a per-row (b,)
``pos`` fails (8 forced host devices in a subprocess, as its own test
runs); the port raises its named error instead.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
TRAIN_ARCHS = ("paper-gpt2-124m", "starcoder2-15b", "granite-moe-1b-a400m")
DECODE_CASES = [(13, None), (40, 16), (63, None), (0, None)]
B, H, KV, S, HD = 4, 4, 2, 64, 16
SOFTCAP = 30.0
LR = 1e-3
LOSS_TOL = 1e-5
MOMENT_TOL = (1e-4, 1e-3)  # after steps 1 and 2
PARAM_ATOL = (2 * LR, 4 * LR)
SEP = "|"


# ---------------------------------------------------------------------------
# Inputs (numpy, from seeds) shared by the world and the reference
# ---------------------------------------------------------------------------


def _decode_inputs():
    rng = np.random.default_rng(0)
    out = []
    for pos, window in DECODE_CASES:
        q = rng.normal(size=(B, H, 1, HD)).astype(np.float32)
        kc = rng.normal(size=(B, KV, S, HD)).astype(np.float32)
        vc = rng.normal(size=(B, KV, S, HD)).astype(np.float32)
        kn = rng.normal(size=(B, KV, 1, HD)).astype(np.float32)
        vn = rng.normal(size=(B, KV, 1, HD)).astype(np.float32)
        out.append(dict(q=q, kc=kc, vc=vc, kn=kn, vn=vn, pos=pos,
                        window=window))
    return out


def _batch(cfg, i, b=4, s=32):
    rng = np.random.default_rng(100 + i)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int64),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)}


def _smoke(arch):
    from repro_torch.models.registry import get_config, get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               fsdp=get_config(arch).fsdp)


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


# ---------------------------------------------------------------------------
# The world (port only: no jax in these processes)
# ---------------------------------------------------------------------------


def _full(t):
    from torch.distributed.tensor import DTensor

    t = t.detach()
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()


def _check_decode(mesh, res):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.layers import PerRowPosError, flash_decode_sharded
    from repro_torch.models.partitioning import (
        PartitionSpec as P,
        make_rules,
        spec_to_placements,
    )

    rules = make_rules(mesh, n_heads=H, n_kv_heads=KV)
    cache_pl = spec_to_placements(mesh, P("data", None, "model", None))
    for i, c in enumerate(_decode_inputs()):
        kc = distribute_tensor(torch.from_numpy(c["kc"]), mesh, cache_pl,
                               src_data_rank=None)
        vc = distribute_tensor(torch.from_numpy(c["vc"]), mesh, cache_pl,
                               src_data_rank=None)
        local_before = kc.to_local().clone()
        out, k2, v2 = flash_decode_sharded(
            torch.from_numpy(c["q"]), kc, vc, torch.from_numpy(c["kn"]),
            torch.from_numpy(c["vn"]), c["pos"], c["window"], SOFTCAP,
            HD ** -0.5, rules)
        moved = (k2.to_local() != local_before).any(dim=(0, 1, 3))
        owner = mesh.get_local_rank("model") == c["pos"] // (S // 2)
        res[f"decode{i}_out"] = _full(out)
        res[f"decode{i}_k"] = _full(k2)
        res[f"decode{i}_v"] = _full(v2)
        res[f"decode{i}_rows_moved"] = np.array(
            int(moved.sum()) if owner else -int(moved.sum()))
    from repro_torch.launch.serve import MeshServingError, VortexServer
    from repro_torch.models.registry import get_smoke_config
    try:
        VortexServer(get_smoke_config("paper-gpt2-124m"), mesh=mesh,
                     device="cpu")
        res["server_refused_mesh"] = np.array(0)
    except MeshServingError:
        res["server_refused_mesh"] = np.array(1)
    try:
        c = _decode_inputs()[0]
        flash_decode_sharded(
            torch.from_numpy(c["q"]), kc, vc, torch.from_numpy(c["kn"]),
            torch.from_numpy(c["vn"]), torch.full((B,), 3), None, SOFTCAP,
            HD ** -0.5, rules)
        res["decode_per_row_raised"] = np.array(0)
    except PerRowPosError:
        res["decode_per_row_raised"] = np.array(1)


def _check_model_decode(res):
    """decode_step on a (1, 4) mesh: the seq-sharded branch, against the
    plain decode from the same weights and cache."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import model as M
    from repro_torch.models.layers import PerRowPosError
    from repro_torch.models.params import init_params, param_pspecs
    from repro_torch.models.partitioning import (
        distribute_tree,
        make_rules,
        replicated_ops,
    )

    mesh = init_device_mesh("cpu", (1, WORLD),
                            mesh_dim_names=("data", "model"))
    cfg = _smoke("starcoder2-15b")
    rules = make_rules(mesh, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    assert rules.rules["kv_heads_act"] is None
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    cache = M.make_cache(cfg, 2, 16, device="cpu")
    for leaf in _flat(cache).values():
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    toks = torch.randint(0, cfg.vocab, (2, 1), generator=g)
    plain = {k: v.clone() for k, v in _flat(cache).items()}
    want, _, _ = M.decode_step(cfg, params, _nest(plain), toks, 9)
    sp = distribute_tree(mesh, params, param_pspecs(cfg, rules))
    sc = distribute_tree(mesh, cache, M.cache_pspecs(cfg, rules, 2, 16))
    with torch.no_grad(), replicated_ops():
        got, _, _ = M.decode_step(cfg, sp, sc, toks, 9, rules=rules)
        try:
            M.decode_step(cfg, sp, sc, toks, torch.full((2,), 9),
                          rules=rules)
            res["model_decode_per_row_raised"] = np.array(0)
        except PerRowPosError:
            res["model_decode_per_row_raised"] = np.array(1)
    res["model_decode_logit_err"] = np.array(
        float(np.abs(_full(got) - want.numpy()).max()))
    res["model_decode_cache_err"] = np.array(max(
        float(np.abs(_full(v) - plain[k].numpy()).max())
        for k, v in _flat(sc).items()))


def _check_async_checkpoint(mesh, res, tmp):
    """Under the Supervisor on a (2, 2) DTensor state: an asynchronous
    save at step 2 whose write rank 0 holds back, then a failure planted
    at step 3; every rank must restore step 2 and end at the same value.
    Then rank 0's write fails, asynchronously and synchronously: every
    rank must raise."""
    import time

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.checkpoint.manager import (
        CheckpointManager,
        CheckpointWriteError,
    )
    from repro_torch.runtime.supervisor import SimulatedFailure, Supervisor

    world = dist.get_world_size()
    x = distribute_tensor(torch.zeros(8, 4), mesh, (Shard(0), Replicate()),
                          src_data_rank=None)
    mgr = CheckpointManager(str(tmp / "async"), keep_n=2)
    if dist.get_rank() == 0:
        write = mgr._write

        def slow(*args):
            time.sleep(1.0)  # the other ranks reach the failure first
            return write(*args)

        mgr._write = slow
    restored = []
    restore = mgr.restore

    def spy(step, template, shardings=None):
        restored.append(step)
        return restore(step, template, shardings)

    mgr.restore = spy

    def planted(step):
        if step == 3 and not restored:
            raise SimulatedFailure("planted at step 3")

    out = Supervisor(mgr, ckpt_every=2).run(
        {"x": x}, lambda s, i: {"x": s["x"] + (i + 1)}, num_steps=5,
        failure_hook=planted)
    final = float(out["x"].full_tensor().max())
    for key, mine in (("async_restored_steps", restored),
                      ("async_final", final)):
        got = [None] * world
        dist.all_gather_object(got, mine)
        res[key] = np.array(got)

    def broken(*args):
        raise OSError("planted: the disk is full")

    for key, save in (("write_error_async",
                       lambda m: (m.save_async(1, {"x": x}), m.wait())),
                      ("write_error_sync", lambda m: m.save(1, {"x": x}))):
        m = CheckpointManager(str(tmp / key))
        if dist.get_rank() == 0:
            m._write = broken
        try:
            save(m)
            raised = "nothing"
        except (OSError, CheckpointWriteError) as e:
            raised = type(e).__name__
        got = [None] * world
        dist.all_gather_object(got, raised)
        res[key] = np.array(got)


def _check_train(mesh, arch, inputs, res, tmp):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.params import param_pspecs, params_from_numpy
    from repro_torch.models.partitioning import (
        distribute_tree,
        make_rules,
        spec_tree_to_shardings,
    )
    from repro_torch.optim.adamw import (
        adamw_init,
        decay_by_rank,
        opt_state_pspecs,
    )
    from repro_torch.runtime.elastic import plan_remesh
    from repro_torch.train.step import TrainHParams, make_train_step

    cfg = _smoke(arch)
    rules = make_rules(mesh, fsdp=cfg.fsdp, n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads)
    flat = {k.split(SEP, 1)[1]: v for k, v in inputs.items()
            if k.startswith(arch + SEP)}
    pp = params_from_numpy(cfg, _nest(flat), device="cpu")
    p_specs = param_pspecs(cfg, rules)
    o_specs = opt_state_pspecs(p_specs, pp, rules.axis_sizes["data"])
    sp = distribute_tree(mesh, pp, p_specs)
    so = adamw_init(sp, mesh=mesh, specs=o_specs)
    hp = TrainHParams(base_lr=LR, warmup_steps=1, total_steps=10,
                      num_microbatches=2)
    pins = o_specs["mu"] if arch.startswith("granite") else None
    step = make_train_step(cfg, hp, rules=rules, grad_pspecs=pins,
                           decay=decay_by_rank(pp))
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, i).items()}
        sp, so, m = step(sp, so, batch)
        res[f"{arch}{SEP}{i}{SEP}loss"] = np.array(float(m["loss"]))
        res[f"{arch}{SEP}{i}{SEP}lr"] = np.array(float(m["lr"]))
        for tree, name in ((sp, "params"), (so["mu"], "mu"),
                           (so["nu"], "nu")):
            for k, v in _flat(tree).items():
                res[f"{arch}{SEP}{i}{SEP}{name}{SEP}{k}"] = _full(v)
    # ZeRO-1: each moment's local shard holds 1 / (the extent of every
    # mesh axis its spec names) of the leaf.
    bad = []
    for k, mu in _flat(so["mu"]).items():
        spec = _flat(o_specs["mu"])[k]
        ext = int(np.prod([rules._extent(p) for p in spec if p is not None]
                          or [1]))
        if mu.to_local().numel() * ext != mu.numel():
            bad.append(k)
    res[f"{arch}{SEP}zero1_bad"] = np.array(len(bad))
    res[f"{arch}{SEP}zero1_sharded"] = np.array(sum(
        any(p is not None and "data" in (p if isinstance(p, tuple) else (p,))
            for p in s) for s in _flat(o_specs["mu"]).values()))
    if arch != TRAIN_ARCHS[0]:
        return
    # Save from (2, 2); restore onto the mesh plan_remesh gives 2 chips.
    from torch.distributed.device_mesh import DeviceMesh

    mgr = CheckpointManager(str(tmp / "ckpt"))
    state = {"params": sp, "opt": so}
    mgr.save(2, state)
    want = {k: _full(v) for k, v in _flat(state).items()}  # every rank
    plan = plan_remesh(2, mesh.shape[1], old_data_extent=mesh.shape[0])
    ranks = torch.arange(plan.chips_used).reshape(plan.mesh_shape)
    small = DeviceMesh("cpu", ranks, mesh_dim_names=plan.mesh_axes)
    res["remesh_shape"] = np.array(plan.mesh_shape)
    if torch.distributed.get_rank() >= plan.chips_used:
        return
    srules = make_rules(small, fsdp=cfg.fsdp, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads)
    s_specs = param_pspecs(cfg, srules)
    specs = {"params": s_specs,
             "opt": opt_state_pspecs(s_specs, pp, plan.data_extent)}
    back = mgr.restore(2, {"params": pp, "opt": adamw_init(pp)},
                       spec_tree_to_shardings(small, specs))
    errs = [float(np.abs(_full(v) - want[k]).max())
            for k, v in _flat(back).items()]
    on_small = all(v.device_mesh is small for k, v in _flat(back).items()
                   if k != f"opt{SEP}step")
    res["remesh_max_err"] = np.array(max(errs))
    res["remesh_on_small_mesh"] = np.array(int(on_small))


def _world(rank, world, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), world), world_size=world, rank=rank)
    try:
        res: dict = {}
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        _check_decode(mesh, res)
        _check_model_decode(res)
        _check_async_checkpoint(mesh, res, tmp)
        with np.load(tmp / "inputs.npz") as z:
            inputs = {k: z[k] for k in z.files}
        for arch in TRAIN_ARCHS:
            _check_train(mesh, arch, inputs, res, tmp)
        dist.barrier()
        if rank == 0:
            np.savez(tmp / "results.npz", **res)
    finally:
        dist.destroy_process_group()


def _run_world(tmp: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_world, args=(WORLD, tmp), nprocs=WORLD)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.models.layers import _decode_attend
    from repro.models.params import init_params as ref_init
    from repro.models.partitioning import make_rules
    from repro.models.registry import get_smoke_config as ref_smoke
    from repro.optim.adamw import adamw_init as ref_adamw_init
    from repro.train.step import TrainHParams as RefHParams
    from repro.train.step import make_train_step as ref_make_step
    return dict(jax=jax, jnp=jnp, Mesh=Mesh, decode=_decode_attend,
                init=ref_init, make_rules=make_rules, smoke=ref_smoke,
                adamw_init=ref_adamw_init, HP=RefHParams,
                make_step=ref_make_step)


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    """The world's results; the reference's initial weights went in."""
    jax = ref["jax"]
    tmp = tmp_path_factory.mktemp("world")
    inputs = {}
    for arch in TRAIN_ARCHS:
        rc = dataclasses.replace(ref["smoke"](arch), dtype="float32")
        rp = jax.tree.map(np.asarray, ref["init"](rc, jax.random.PRNGKey(3)))
        inputs.update({f"{arch}{SEP}{k}": v for k, v in _flat(rp).items()})
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, __file__, str(tmp)], capture_output=True,
        text=True, timeout=300, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(tmp / "results.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", range(len(DECODE_CASES)))
def test_flash_decode_sharded_matches_the_dense_reference(world, ref, case):
    jnp, jax = ref["jnp"], ref["jax"]
    c = _decode_inputs()[case]
    p = c["pos"]
    kr = jax.lax.dynamic_update_slice(jnp.asarray(c["kc"]),
                                      jnp.asarray(c["kn"]), (0, 0, p, 0))
    vr = jax.lax.dynamic_update_slice(jnp.asarray(c["vc"]),
                                      jnp.asarray(c["vn"]), (0, 0, p, 0))
    want = ref["decode"](jnp.asarray(c["q"]), kr, vr, jnp.asarray(p,
                         jnp.int32), c["window"], SOFTCAP, HD ** -0.5)
    np.testing.assert_allclose(world[f"decode{case}_out"], np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    # The writes are exact: the new row at pos, every other row as it was.
    np.testing.assert_array_equal(world[f"decode{case}_k"], np.asarray(kr))
    np.testing.assert_array_equal(world[f"decode{case}_v"], np.asarray(vr))
    # Rank 0 of each decode owns rows 0..31 (model rank 0): it moved one
    # row when it owns pos, none otherwise (the sign marks ownership).
    moved = int(world[f"decode{case}_rows_moved"])
    assert moved == (1 if p < S // 2 else 0), moved


def test_sharded_decode_refuses_a_per_row_pos(world):
    assert int(world["decode_per_row_raised"]) == 1
    assert int(world["model_decode_per_row_raised"]) == 1


def test_server_refuses_a_mesh_of_more_than_one_rank(world):
    assert int(world["server_refused_mesh"]) == 1


def test_model_decode_takes_the_seq_sharded_branch(world):
    # float32 through 2 layers: the all-reduced softmax against the
    # plain one differs by rounding only.
    assert float(world["model_decode_logit_err"]) < 1e-5
    assert float(world["model_decode_cache_err"]) < 1e-5


def test_async_checkpoint_restores_the_same_step_on_every_rank(world):
    # Every rank waits for rank 0's held-back write of step 2, restores
    # it, and replays to 1 + 2 + 3 + 4 + 5.
    assert world["async_restored_steps"].tolist() == [[2]] * WORLD
    assert world["async_final"].tolist() == [15.0] * WORLD


def test_checkpoint_write_error_reaches_every_rank(world):
    want = ["OSError"] + ["CheckpointWriteError"] * (WORLD - 1)
    assert world["write_error_async"].tolist() == want
    assert world["write_error_sync"].tolist() == want


def _leaf_err(a, b):
    return float(np.abs(a - b).max()) if a.size else 0.0


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_steps_match_the_reference(world, ref, arch):
    jax, jnp = ref["jax"], ref["jnp"]
    rc = dataclasses.replace(ref["smoke"](arch), dtype="float32")
    mesh = ref["Mesh"](np.array(jax.devices()[:1]).reshape(1, 1),
                       ("data", "model"))
    rules = ref["make_rules"](mesh, fsdp=rc.fsdp, n_heads=rc.n_heads,
                              n_kv_heads=rc.n_kv_heads)
    rp = ref["init"](rc, jax.random.PRNGKey(3))
    hp = ref["HP"](base_lr=LR, warmup_steps=1, total_steps=10,
                   num_microbatches=2)
    step = jax.jit(ref["make_step"](rc, rules, hp))
    ro = ref["adamw_init"](rp)
    for i in range(2):
        batch = {k: jnp.asarray(v.astype(np.int32))
                 for k, v in _batch(rc, i).items()}
        rp, ro, rm = step(rp, ro, batch)
        pre = f"{arch}{SEP}{i}{SEP}"
        assert float(world[pre + "loss"]) == pytest.approx(
            float(rm["loss"]), rel=LOSS_TOL), i
        assert float(world[pre + "lr"]) == float(rm["lr"])
        for name, tree, tol in (
                ("params", rp, None), ("mu", ro["mu"], MOMENT_TOL[i]),
                ("nu", ro["nu"], MOMENT_TOL[i])):
            r = _flat(jax.tree.map(np.asarray, tree))
            for k, want in r.items():
                got = world[f"{pre}{name}{SEP}{k}"]
                err = _leaf_err(got, want)
                bound = (PARAM_ATOL[i] if tol is None else
                         tol * max(float(np.abs(want).max()), 1e-30))
                assert err <= bound, (i, name, k, err)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_zero1_moments_are_sharded_on_the_mesh(world, arch):
    assert int(world[f"{arch}{SEP}zero1_bad"]) == 0
    # Some moments gain the data axis (FSDP's inherit it from the params).
    assert int(world[f"{arch}{SEP}zero1_sharded"]) > 0


def test_checkpoint_restores_exactly_onto_the_smaller_mesh(world):
    assert tuple(world["remesh_shape"]) == (1, 2)
    assert float(world["remesh_max_err"]) == 0.0
    assert int(world["remesh_on_small_mesh"]) == 1


_C15 = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.models.partitioning import make_rules
    from repro.models.layers import flash_decode_sharded

    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    rules = make_rules(mesh, n_heads=4, n_kv_heads=2)
    b, H, KV, S, hd = 4, 4, 2, 64, 16
    z = jnp.zeros
    try:
        jax.jit(lambda *a: flash_decode_sharded(
            *a, None, None, hd ** -0.5, rules))(
            z((b, H, 1, hd)), z((b, KV, S, hd)), z((b, KV, S, hd)),
            z((b, KV, 1, hd)), z((b, KV, 1, hd)),
            jnp.asarray([3, 17, 40, 63], jnp.int32))
        print("NO ERROR")
    except Exception as e:
        print("RAISED", type(e).__name__)
    """
)


def test_c15_reference_sharded_decode_fails_on_a_per_row_pos():
    """ROADMAP C15: the reference's sharded decode takes ``pos`` as one
    replicated scalar (``P()``); a (b,) vector, as mixed-progress decode
    passes, fails there (the cache write's start index must be a
    scalar).  The port raises ``PerRowPosError`` (above)."""
    pytest.importorskip("jax")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _C15], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "RAISED" in out.stdout, out.stdout


if __name__ == "__main__":
    _run_world(sys.argv[1])
