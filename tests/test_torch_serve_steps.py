"""The serve-step builders (``make_prefill_step``, ``make_decode_step``)
on a mesh for every cache family, against the JAX package's builders on
the same weights and prompts.

Two subprocesses run at once, each under ``subprocess.run``-style limits
of 300 s:

* the port: a world of 4 gloo ranks (``python
  tests/test_torch_serve_steps.py <dir>``; FileStore rendezvous under the
  test's temporary directory).  Each case lays the reference's weights
  out by ``param_pspecs`` on its mesh, runs the prefill on a (4, 12)
  prompt (sharded over the batch axes, with whisper's encoder frames and
  internvl2's patch embeddings), lays the cache out by ``cache_pspecs``,
  then takes two greedy decode steps at scalar positions 12 and 13.
  Rank 0 writes the logits, the tokens, every cache leaf after each step,
  and how many times the sequence-sharded flash decode ran;
* the reference: the same builders jitted with the same rules on 4 forced
  host devices (``--xla_force_host_platform_device_count``, as
  tests/test_flash_decode_multidev.py), in/out shardings as its dry run
  gives them.

Cases: starcoder2-15b (GQA) on the (2, 2) mesh, where its 2 kv heads
divide the model axis and decode shards the cache on heads, and on a
(1, 4) mesh, where they do not and decode takes the sequence-sharded
branch; deepseek-v2-236b (``ckv``/``k_rope``), falcon-mamba-7b
(``conv``/``ssm``), jamba-v0.1-52b (both), whisper-small
(``encoder_out``) and internvl2-26b (the vision prefix), each on (2, 2).
Float32 smoke configs with the full configs' ``fsdp``.  Held: the greedy
tokens identical; the logits (the real vocab columns) and every cache
leaf after each step within 1e-4 of the reference's largest magnitude in
that leaf (the two packages and the shards reduce in different orders).
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
CASES = (
    ("starcoder2-15b", (2, 2)),
    ("starcoder2-15b", (1, 4)),
    ("deepseek-v2-236b", (2, 2)),
    ("falcon-mamba-7b", (2, 2)),
    ("jamba-v0.1-52b", (2, 2)),
    ("whisper-small", (2, 2)),
    ("internvl2-26b", (2, 2)),
)
ARCHS = tuple(dict.fromkeys(a for a, _ in CASES))
B, S, CACHE_LEN, DECODES = 4, 12, 16, 2
TOL = 1e-4
SEP = "|"


def _case(arch, mesh_shape) -> str:
    return f"{arch}@{mesh_shape[0]}x{mesh_shape[1]}"


def _prompt(cfg) -> dict:
    rng = np.random.default_rng(11)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.vision_prefix:
        out["vision_embeds"] = rng.normal(
            size=(B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    if cfg.encoder_decoder:
        out["encoder_frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
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


# ---------------------------------------------------------------------------
# The port's world (no jax in these processes)
# ---------------------------------------------------------------------------


def _world(rank, world, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.models.params import param_pspecs, params_from_numpy
    from repro_torch.models.partitioning import (
        distribute_tree,
        make_rules,
        replicated_ops,
        spec_to_placements,
    )
    from repro_torch.models.registry import get_config, get_smoke_config
    from repro_torch.train.step import (
        make_decode_step,
        make_prefill_step,
        shard_batch,
    )

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), world), world_size=world, rank=rank)
    calls = [0]
    sharded = layers.flash_decode_sharded

    def counted(*args, **kwargs):
        calls[0] += 1
        return sharded(*args, **kwargs)

    layers.flash_decode_sharded = counted

    def full(t):
        t = t.detach()
        return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()

    try:
        with np.load(tmp / "inputs.npz") as z:
            inputs = {k: z[k] for k in z.files}
        res = {}
        for arch, shape in CASES:
            case = _case(arch, shape)
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
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
            batch = shard_batch({k: torch.from_numpy(v)
                                 for k, v in _prompt(cfg).items()}, rules)
            prefill = make_prefill_step(cfg, rules, CACHE_LEN)
            decode = make_decode_step(cfg, rules, CACHE_LEN)
            c_specs = M.cache_pspecs(cfg, rules, B, CACHE_LEN)
            with torch.no_grad(), replicated_ops():
                logits, cache = prefill(params, batch)
                cache = {k: (v.redistribute(mesh, spec_to_placements(
                    mesh, _flat(c_specs)[k])) if isinstance(v, DTensor)
                    else v) for k, v in _flat(cache).items()}
                cache = _nest(cache)
                calls[0] = 0
                for step in range(DECODES + 1):
                    res[f"{case}{SEP}{step}{SEP}logits"] = full(logits)
                    for k, v in _flat(cache).items():
                        res[f"{case}{SEP}{step}{SEP}cache{SEP}{k}"] = full(v)
                    if step == DECODES:
                        break
                    tok = full(logits)[:, :cfg.vocab].argmax(-1)
                    res[f"{case}{SEP}{step}{SEP}tokens"] = tok
                    toks = shard_batch({"tokens": torch.from_numpy(
                        tok[:, None].astype(np.int32))}, rules)["tokens"]
                    logits, cache = decode(params, cache, toks, S + step)
            res[f"{case}{SEP}seq_sharded_calls"] = np.array(calls[0])
        dist.barrier()
        if rank == 0:
            np.savez(tmp / "results.npz", **res)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference, on 4 forced host devices
# ---------------------------------------------------------------------------

_REF = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, pathlib, sys
    sys.path.insert(0, "src")
    sys.path.insert(0, "tests")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.models import model as M
    from repro.models.params import param_pspecs
    from repro.models.partitioning import make_rules, spec_tree_to_shardings
    from repro.models.registry import get_config, get_smoke_config
    from repro.train.step import make_decode_step, make_prefill_step
    import test_torch_serve_steps as T

    tmp = pathlib.Path(sys.argv[1])
    with np.load(tmp / "inputs.npz") as z:
        inputs = {k: z[k] for k in z.files}
    res = {}
    for arch, shape in T.CASES:
        case = T._case(arch, shape)
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                  fsdp=get_config(arch).fsdp)
        rules = make_rules(mesh, fsdp=cfg.fsdp, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads)
        flat = {k.split(T.SEP, 1)[1]: jnp.asarray(v)
                for k, v in inputs.items() if k.startswith(arch + T.SEP)}
        p_sh = spec_tree_to_shardings(mesh, param_pspecs(cfg, rules))
        params = jax.device_put(T._nest(flat), p_sh)
        bspec = rules.sanitize(P(rules.rules.get("batch")), (T.B,))
        prompt = {k: jnp.asarray(v) for k, v in T._prompt(cfg).items()}
        b_sh = {k: NamedSharding(mesh, bspec) for k in prompt}
        c_sh = spec_tree_to_shardings(
            mesh, M.cache_pspecs(cfg, rules, T.B, T.CACHE_LEN))
        prefill = jax.jit(make_prefill_step(cfg, rules, T.CACHE_LEN),
                          in_shardings=(p_sh, b_sh),
                          out_shardings=(None, c_sh))
        decode = jax.jit(make_decode_step(cfg, rules, T.CACHE_LEN),
                         in_shardings=(p_sh, c_sh, NamedSharding(mesh, bspec),
                                       NamedSharding(mesh, P())),
                         out_shardings=(None, c_sh))
        logits, cache = prefill(params, prompt)
        for step in range(T.DECODES + 1):
            res[f"{case}{T.SEP}{step}{T.SEP}logits"] = np.asarray(logits)
            for k, v in T._flat(cache).items():
                res[f"{case}{T.SEP}{step}{T.SEP}cache{T.SEP}{k}"] = (
                    np.asarray(v))
            if step == T.DECODES:
                break
            tok = np.asarray(logits)[:, :cfg.vocab].argmax(-1)
            res[f"{case}{T.SEP}{step}{T.SEP}tokens"] = tok
            logits, cache = decode(params, cache,
                                   jnp.asarray(tok[:, None], jnp.int32),
                                   jnp.asarray(T.S + step, jnp.int32))
    np.savez(tmp / "ref.npz", **res)
    """
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's results, the reference's)."""
    jax = pytest.importorskip("jax")
    from repro.models.params import init_params as ref_init
    from repro.models.registry import get_smoke_config as ref_smoke

    tmp = tmp_path_factory.mktemp("serve_steps")
    inputs = {}
    for arch in ARCHS:
        rc = dataclasses.replace(ref_smoke(arch), dtype="float32")
        w = ref_init(rc, jax.random.PRNGKey(0))
        inputs.update({f"{arch}{SEP}{k}": v for k, v in
                       _flat(jax.tree.map(np.asarray, w)).items()})
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen([sys.executable, __file__, str(tmp)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=str(ROOT), env=env),
        subprocess.Popen([sys.executable, "-c", _REF, str(tmp)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=str(ROOT), env=env),
    ]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    with np.load(tmp / "results.npz") as z:
        got = {k: z[k] for k in z.files}
    with np.load(tmp / "ref.npz") as z:
        want = {k: z[k] for k in z.files}
    return got, want


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= TOL * max(scale, 1e-30), (what, err, scale)


@pytest.mark.parametrize("arch,mesh_shape", CASES,
                         ids=[_case(a, m) for a, m in CASES])
def test_serve_steps_match_the_reference(runs, arch, mesh_shape):
    from repro_torch.models.registry import get_smoke_config

    got, want = runs
    case = _case(arch, mesh_shape)
    vocab = get_smoke_config(arch).vocab
    keys = sorted(k for k in want if k.startswith(case + SEP))
    assert keys == sorted(k for k in got if k.startswith(case + SEP)
                          and not k.endswith("seq_sharded_calls"))
    for step in range(DECODES):
        k = f"{case}{SEP}{step}{SEP}tokens"
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in keys:
        if k.endswith(f"{SEP}logits"):
            _close(got[k][:, :vocab], want[k][:, :vocab], k)
        elif f"{SEP}cache{SEP}" in k:
            _close(got[k], want[k], k)


@pytest.mark.parametrize("arch,mesh_shape", CASES,
                         ids=[_case(a, m) for a, m in CASES])
def test_decode_branch_per_family(runs, arch, mesh_shape):
    """The sequence-sharded flash decode runs once per attention layer
    and step where the kv heads do not divide the model axis (starcoder2
    on (1, 4)), and never elsewhere: MLA and Mamba have no kv-head cache,
    and every other attention cache here shards on its heads."""
    from repro_torch.models.registry import get_smoke_config

    got, _ = runs
    cfg = get_smoke_config(arch)
    attn_layers = cfg.n_groups * sum(p.mixer == "attn" for p in cfg.pattern)
    seq = cfg.n_kv_heads % mesh_shape[1] != 0 and attn_layers > 0
    want = DECODES * attn_layers if seq else 0
    assert int(got[f"{_case(arch, mesh_shape)}{SEP}seq_sharded_calls"]) == want


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.spawn(_world, args=(WORLD, sys.argv[1]), nprocs=WORLD)
