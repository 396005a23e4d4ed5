"""The port's partitioning rules and spec trees against the JAX package's
(src/repro/models/partitioning.py, params.py, model.py, train/step.py,
optim/adamw.py, runtime/elastic.py), on meshes described by their axis
sizes alone (``launch.mesh.MeshShape``, the reference's ``AbstractMesh``):
no process is started here except the one-rank host mesh's.

Mirrors tests/test_partitioning_hlo.py's ``TestRules`` and spec-tree
cases, tests/test_optim.py's ZeRO-1 case and
tests/test_checkpoint_runtime.py's ``TestElastic``, then holds every spec
tree of every registered architecture equal to the reference's, spec for
spec as tuples, at the production meshes (16, 16) and (2, 16, 16) with
each config's ``fsdp``.
"""
import dataclasses

import pytest
import torch

from repro_torch.launch import mesh as meshes
from repro_torch.launch.mesh import MeshShape, MeshSizeError
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES
from repro_torch.models.params import model_schema, param_pspecs
from repro_torch.models.partitioning import (
    PartitionSpec as P,
    constrain,
    make_rules,
    spec_to_placements,
)
from repro_torch.models.registry import ARCH_IDS, get_config
from repro_torch.optim.adamw import opt_state_pspecs
from repro_torch.runtime.elastic import plan_remesh
from repro_torch.train.step import serve_input_specs, train_input_specs

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _rules(shape=(16, 16), axes=("data", "model"), fsdp=False, n_heads=16,
           n_kv_heads=8):
    return make_rules(MeshShape(shape, axes), fsdp=fsdp, n_heads=n_heads,
                      n_kv_heads=n_kv_heads)


def _leaves(tree, pre=()):
    """{path: leaf} with PartitionSpecs (tuples) as leaves."""
    if not isinstance(tree, dict):
        return {pre: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, pre + (k,)))
    return out


def _shapes(cfg):
    return {k: d.shape for k, d in _leaves(model_schema(cfg)).items()}


class TestRules:
    def test_sanitize_drops_non_divisible(self):
        r = _rules()
        assert r.sanitize(P("model"), (49155,)) == P()
        assert r.sanitize(P("model"), (49152,)) == P("model")
        assert r.sanitize(P(("pod", "data")), (1,)) == P()

    def test_heads_act_requires_divisibility(self):
        r = _rules(n_heads=24)  # 24 % 16 != 0
        assert r.rules["heads_act"] is None
        r2 = _rules(n_heads=32)
        assert r2.rules["heads_act"] == "model"

    def test_fsdp_maps_embed_to_data(self):
        assert _rules(fsdp=True).rules["embed"] == "data"
        assert _rules(fsdp=False).rules["embed"] is None

    def test_multipod_batch_spans_pod_and_data(self):
        r = _rules(shape=(2, 16, 16), axes=("pod", "data", "model"))
        assert r.rules["batch"] == ("pod", "data")

    def test_tuple_axis_degrades_and_trailing_nones_trim(self):
        r = _rules(shape=(2, 16, 16), axes=("pod", "data", "model"))
        # (pod, data) needs 32 rows; 16 keeps 'data' alone.
        assert r.sanitize(P(("pod", "data"), None), (16, 4)) == P("data")
        assert r.sanitize(P(("pod", "data")), (64,)) == P(("pod", "data"))
        # One mesh axis names one dim at most.
        assert r.sanitize(P("model", "model"), (32, 32)) == P("model")
        assert r.resolve(("batch", None, "none")) == P(("pod", "data"))


class TestSpecTrees:
    @pytest.mark.parametrize("arch", ["gemma2-9b", "deepseek-v2-236b",
                                      "falcon-mamba-7b", "whisper-small"])
    def test_param_specs_cover_every_leaf_and_divide(self, arch):
        cfg = get_config(arch)
        r = _rules(fsdp=cfg.fsdp, n_heads=cfg.n_heads,
                   n_kv_heads=cfg.n_kv_heads)
        shapes = _shapes(cfg)
        specs = _leaves(param_pspecs(cfg, r))
        assert specs.keys() == shapes.keys()
        for k, spec in specs.items():
            assert isinstance(spec, P)
            for i, part in enumerate(spec):
                if part is not None:
                    assert shapes[k][i] % r._extent(part) == 0, (k, spec)

    def test_cache_specs_match_cache_tree(self):
        cfg = get_config("jamba-v0.1-52b")
        r = _rules(n_heads=32, n_kv_heads=8)
        cache = M.abstract_cache(cfg, batch=128, cache_len=1024)
        specs = M.cache_pspecs(cfg, r, batch=128, cache_len=1024)
        assert set(cache) == set(specs)
        c, s = _leaves(cache), _leaves(specs)
        assert c.keys() == s.keys()
        for k in c:
            assert len(s[k]) <= c[k].ndim, k

    def test_input_specs_all_cells(self):
        r = _rules()
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for shape in SHAPES.values():
                fn = (train_input_specs if shape.kind == "train"
                      else serve_input_specs)
                specs, ps = fn(cfg, shape, r)
                assert "tokens" in specs and "tokens" in ps
                assert specs.keys() == ps.keys()
                assert all(t.device.type == "meta" for t in specs.values())


def test_opt_state_zero1_sharding():
    specs = {"w": P(None, "model"), "b": P()}
    shapes = {"w": torch.empty((64, 128), device="meta"),
              "b": torch.empty((7,), device="meta")}
    out = opt_state_pspecs(specs, shapes, data_axis_size=16)
    # w's first (unsharded, divisible) axis picks up 'data'; b (7) cannot.
    assert out["mu"]["w"] == P("data", "model")
    assert out["mu"]["b"] == P()
    assert out["step"] == P()
    # FSDP-sharded params: the moments inherit the param's spec.
    fsdp = opt_state_pspecs({"w": P("data", "model")}, {"w": shapes["w"]},
                            data_axis_size=16)
    assert fsdp["nu"]["w"] == P("data", "model")


class TestElastic:
    def test_shrinks_data_axis_keeps_model(self):
        plan = plan_remesh(healthy_chips=192, model_extent=16,
                           old_data_extent=16)
        assert plan.mesh_shape == (8, 16)
        assert plan.microbatch_scale == 2
        assert plan.chips_used == 128

    def test_multi_pod(self):
        plan = plan_remesh(healthy_chips=480, model_extent=16,
                           old_data_extent=16, pods=2)
        assert plan.mesh_axes == ("pod", "data", "model")
        assert plan.data_extent in (8, 16)

    def test_too_few_chips_raises(self):
        with pytest.raises(ValueError):
            plan_remesh(healthy_chips=8, model_extent=16,
                        old_data_extent=16)


def test_spec_to_placements_and_constrain_on_plain_tensors():
    from torch.distributed.tensor import Replicate, Shard

    ms = MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert spec_to_placements(ms, P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert spec_to_placements(ms, P()) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        spec_to_placements(ms, P(("data", "pod")))
    # A layout hint never touches a plain tensor: same object back.
    x = torch.randn(4, 8, 16)
    r = _rules()
    assert r.mesh is None
    assert constrain(x, r, "batch", "seq", None) is x
    assert constrain(x, None, "batch") is x
    mesh_rules = dataclasses.replace(r, mesh=object())
    assert constrain(x, mesh_rules, "batch", "seq", None) is x


def test_meshes_refuse_a_world_of_the_wrong_size():
    assert not torch.distributed.is_initialized()
    with pytest.raises(MeshSizeError):
        meshes.make_production_mesh(device="cpu")
    with pytest.raises(MeshSizeError):
        meshes.make_host_mesh(2, 1, device="cpu")
    assert not torch.distributed.is_initialized()


def test_host_mesh_starts_and_ends_its_own_group():
    mesh = meshes.make_host_mesh(device="cpu")
    try:
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        r = make_rules(mesh, n_heads=12, n_kv_heads=12)
        assert r.mesh is mesh and r.axis_sizes == {"data": 1, "model": 1}
        # Extent-1 axes place nothing: every placement replicates.
        assert all(pl.is_replicate() for pl in spec_to_placements(
            mesh, P("data", "model")))
    finally:
        meshes.destroy()
    assert not torch.distributed.is_initialized()


def test_server_on_the_host_mesh_serves_the_same_tokens():
    """``VortexServer(mesh=make_host_mesh())`` builds the reference's
    rules and serves the same greedy tokens as the server without a
    mesh, on the same weights (the constraints are no-ops on its plain
    tensors)."""
    import numpy as np

    from repro_torch.launch.serve import Request, VortexServer
    from repro_torch.models.params import init_params
    from repro_torch.models.registry import get_smoke_config

    cfg = get_smoke_config("paper-gpt2-124m")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 21))
    kw = dict(max_cache=64, params=params, device="cpu",
              hardware="tpu_v5e")
    want = VortexServer(cfg, **kw).generate(Request(tokens=toks, max_new=4))
    mesh = meshes.make_host_mesh(device="cpu")
    try:
        server = VortexServer(cfg, mesh=mesh, **kw)
        assert server.rules.mesh is mesh
        assert server.rules.rules == make_rules(
            MeshShape((1, 1), ("data", "model")), n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads).rules
        got = server.generate(Request(tokens=toks, max_new=4))
    finally:
        meshes.destroy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Spec for spec against the JAX package
# ---------------------------------------------------------------------------


def _ref():
    jax = pytest.importorskip("jax")
    import repro.models.model as RM
    from repro.models.params import abstract_params
    from repro.models.params import param_pspecs as ref_param_pspecs
    from repro.models.partitioning import make_rules as ref_make_rules
    from repro.models.registry import get_config as ref_get_config
    from repro.optim.adamw import opt_state_pspecs as ref_opt_pspecs
    from repro.train.step import serve_input_specs as ref_serve
    from repro.train.step import train_input_specs as ref_train
    return dict(jax=jax, RM=RM, abstract_params=abstract_params,
                param_pspecs=ref_param_pspecs, make_rules=ref_make_rules,
                get_config=ref_get_config, opt_pspecs=ref_opt_pspecs,
                serve=ref_serve, train=ref_train)


def _abstract_mesh(jax, shape, axes):
    try:
        return jax.sharding.AbstractMesh(shape, axes)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(axes, shape)))


def _ref_leaves(jax, tree):
    from jax.sharding import PartitionSpec
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {tuple(str(getattr(k, "key", k)) for k in path): v
            for path, v in flat}


def _both(arch, mesh):
    ref = _ref()
    shape, axes = MESHES[mesh]
    rc, pc = ref["get_config"](arch), get_config(arch)
    kw = dict(fsdp=pc.fsdp, n_heads=pc.n_heads, n_kv_heads=pc.n_kv_heads)
    rr = ref["make_rules"](_abstract_mesh(ref["jax"], shape, axes), **kw)
    pr = make_rules(MeshShape(shape, axes), **kw)
    return ref, rc, pc, rr, pr


def _same(ref, ours, theirs):
    a, b = _leaves(ours), _ref_leaves(ref["jax"], theirs)
    assert a.keys() == b.keys()
    for k in a:
        assert isinstance(a[k], P), k
        assert tuple(a[k]) == tuple(b[k]), (k, a[k], b[k])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal_the_reference(arch, mesh):
    ref, rc, pc, rr, pr = _both(arch, mesh)
    assert dict(pr.rules) == dict(rr.rules)
    ps = param_pspecs(pc, pr)
    _same(ref, ps, ref["param_pspecs"](rc, rr))
    data = pr.axis_sizes["data"]
    meta = {k: torch.empty(s, device="meta") for k, s in _shapes(pc).items()}
    shapes = {}
    for path, t in meta.items():
        node = shapes
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    _same(ref, opt_state_pspecs(ps, shapes, data),
          ref["opt_pspecs"](ref["param_pspecs"](rc, rr),
                            ref["abstract_params"](rc), data))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_input_specs_equal_the_reference(arch, mesh):
    ref, rc, pc, rr, pr = _both(arch, mesh)
    for batch, cache_len in ((128, 1024), (1, 32768), (6, 1000)):
        _same(ref, M.cache_pspecs(pc, pr, batch, cache_len),
              ref["RM"].cache_pspecs(rc, rr, batch, cache_len))
    from repro.models.config import SHAPES as REF_SHAPES
    for name, shape in SHAPES.items():
        fn, rfn = ((train_input_specs, ref["train"]) if shape.kind == "train"
                   else (serve_input_specs, ref["serve"]))
        specs, ps = fn(pc, shape, pr)
        rspecs, rps = rfn(rc, REF_SHAPES[name], rr)
        assert ps.keys() == rps.keys()
        for k in ps:
            assert tuple(ps[k]) == tuple(rps[k]), (name, k)
            assert tuple(specs[k].shape) == tuple(rspecs[k].shape)
            assert str(specs[k].dtype).split(".")[-1] == str(rspecs[k].dtype)


def test_plan_remesh_equals_the_reference_over_a_grid():
    pytest.importorskip("jax")
    from repro.runtime.elastic import plan_remesh as ref_plan

    n = 0
    for pods in (1, 2):
        for model in (1, 2, 4, 8, 16):
            for old in (1, 2, 3, 4, 6, 8, 12, 16):
                for healthy in range(model, pods * old * model + 1,
                                     max(1, model // 2)):
                    got = plan_remesh(healthy, model, old_data_extent=old,
                                      pods=pods)
                    want = ref_plan(healthy, model, old_data_extent=old,
                                    pods=pods)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want)
                    assert got.data_extent == want.data_extent
                    n += 1
    assert n > 1000
    with pytest.raises(ValueError):
        plan_remesh(3, 4, old_data_extent=2)
