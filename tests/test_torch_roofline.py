"""The port's roofline package against the JAX package's:

* ``tree_device_bytes`` of the parameter, cache and ZeRO-1 moment trees
  of every dry-run cell on the (16, 16) and (2, 16, 16) meshes, exactly
  (rules from a ``MeshShape`` here, an ``AbstractMesh`` there: no
  devices), and the reference's fits-in-HBM check;
* ``model_flops`` of every cell, exactly;
* ``op_counts`` on the four cases of the reference's ``TestHloParser``
  (tests/test_partitioning_hlo.py:118-157): a loop of 7 products counted
  7 times, a plain (32, 48) @ (48, 16) with the reference's FLOPs and
  bytes exactly, collectives with bytes (a fake 4-rank world), positive
  memory bytes; and a DTensor product counted on its local operands only;
* a dense smoke prefill's FLOPs against the reference's trip-corrected
  HLO count, within 2% (they agree exactly);
* ``roofline_report`` at ``V5E`` on equal costs, field for field.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES
from repro_torch.models.params import abstract_params, param_pspecs
from repro_torch.models.partitioning import make_rules
from repro_torch.models.registry import (
    ASSIGNED_ARCH_IDS,
    all_cells,
    get_config,
)
from repro_torch.optim.adamw import adamw_init, opt_state_pspecs
from repro_torch.roofline import (
    V5E,
    ModuleCosts,
    count_costs,
    fits_hbm,
    model_flops,
    roofline_report,
    tree_device_bytes,
)

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
FLOP_TOL = 0.02


def _ref_rules(shape, axes, cfg):
    import jax
    from repro.models.partitioning import make_rules as ref_make_rules

    try:
        mesh = jax.sharding.AbstractMesh(shape, axes)
    except TypeError:
        mesh = jax.sharding.AbstractMesh(tuple(zip(axes, shape)))
    return ref_make_rules(mesh, fsdp=cfg.fsdp, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads)


def _trees(cfg, rules, shape_name, axis_sizes, *, ref):
    """{name: bytes per device} of one cell's state trees, from the port's
    or the reference's modules."""
    if ref:
        from repro.models import model as RM
        from repro.models.params import abstract_params as ap
        from repro.models.params import param_pspecs as pp
        from repro.optim.adamw import adamw_init as ai
        from repro.optim.adamw import opt_state_pspecs as osp
        from repro.roofline.memory import tree_device_bytes as tdb
        mods = (RM, ap, pp, ai, osp, tdb)
    else:
        mods = (M, abstract_params, param_pspecs, adamw_init,
                opt_state_pspecs, tree_device_bytes)
    model, ap, pp, ai, osp, tdb = mods
    shape = SHAPES[shape_name]
    params, specs = ap(cfg), pp(cfg, rules)
    out = {"params": tdb(params, specs, axis_sizes)}
    if shape.kind == "train":
        opt = ai(params)
        o_specs = osp(specs, params, axis_sizes.get("data", 1), zero1=True)
        out["mu"] = tdb(opt["mu"], o_specs["mu"], axis_sizes)
        out["nu"] = tdb(opt["nu"], o_specs["nu"], axis_sizes)
    else:
        b, s = shape.global_batch, shape.seq_len
        out["cache"] = tdb(model.abstract_cache(cfg, b, s),
                           model.cache_pspecs(cfg, rules, b, s), axis_sizes)
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCH_IDS)
def test_state_bytes_equal_the_reference(arch, mesh):
    pytest.importorskip("jax")
    from repro.models.registry import get_config as ref_config

    shape, axes = MESHES[mesh]
    axis_sizes = dict(zip(axes, shape))
    cfg, rcfg = get_config(arch), ref_config(arch)
    rules = make_rules(MeshShape(shape, axes), fsdp=cfg.fsdp,
                       n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    rrules = _ref_rules(shape, axes, rcfg)
    for a, shape_name in all_cells():
        if a != arch:
            continue
        got = _trees(cfg, rules, shape_name, axis_sizes, ref=False)
        want = _trees(rcfg, rrules, shape_name, axis_sizes, ref=True)
        assert got == want, (shape_name, got, want)


def test_big_models_fit_hbm_under_sharding():
    """The FSDP+TP layout puts deepseek-v2's parameters well under 16 GB a
    chip (the reference's test_big_models_fit_hbm_under_sharding)."""
    cfg = get_config("deepseek-v2-236b")
    r = make_rules(MeshShape((16, 16), ("data", "model")), fsdp=True,
                   n_heads=128, n_kv_heads=128)
    nbytes = tree_device_bytes(abstract_params(cfg), param_pspecs(cfg, r),
                               {"data": 16, "model": 16})
    assert nbytes < 4 * 2**30  # params alone < 4 GiB/chip
    assert fits_hbm(nbytes, V5E.hbm_bytes)
    assert not fits_hbm(V5E.hbm_bytes, V5E.hbm_bytes)


def test_abstract_params_allocate_nothing():
    params = abstract_params(get_config("deepseek-v2-236b"))
    leaves = [params]
    while leaves:
        x = leaves.pop()
        if isinstance(x, dict):
            leaves.extend(x.values())
        else:
            assert x.device.type == "meta"


def test_model_flops_equal_the_reference():
    pytest.importorskip("jax")
    from repro.models.params import count_params as ref_count
    from repro.models.registry import get_config as ref_config
    from repro.roofline.analysis import model_flops as ref_flops
    from repro.models.config import SHAPES as REF_SHAPES

    from repro_torch.models.params import count_params

    for arch, shape_name in all_cells():
        cfg, rcfg = get_config(arch), ref_config(arch)
        n, rn = count_params(cfg), ref_count(rcfg)
        assert n == rn
        got = model_flops(cfg, SHAPES[shape_name], n,
                          cfg.active_param_count())
        want = ref_flops(rcfg, REF_SHAPES[shape_name], rn,
                         rcfg.active_param_count())
        assert got == want, (arch, shape_name)


# ---------------------------------------------------------------------------
# op_counts: the reference's TestHloParser cases
# ---------------------------------------------------------------------------


def test_loop_of_products_counted_per_iteration():
    x = torch.randn(64, 64)

    def f(c):
        for _ in range(7):
            c = c @ c
        return c

    _, costs = count_costs(f, x)
    assert costs.flops == 7 * 2 * 64**3
    assert costs.while_trip_counts == {}


def _ref_plain_dot():
    import jax
    import jax.numpy as jnp
    from repro.roofline.hlo_parse import parse_hlo_costs

    compiled = jax.jit(lambda a, b: a @ b).lower(
        jax.ShapeDtypeStruct((32, 48), jnp.float32),
        jax.ShapeDtypeStruct((48, 16), jnp.float32),
    ).compile()
    return parse_hlo_costs(compiled.as_text())


def test_plain_dot_flops_and_bytes_equal_the_reference():
    pytest.importorskip("jax")
    want = _ref_plain_dot()
    _, got = count_costs(torch.matmul, torch.randn(32, 48),
                         torch.randn(48, 16))
    assert got.flops == want.flops == 2 * 32 * 48 * 16
    assert got.memory_bytes == want.memory_bytes


def test_memory_bytes_positive():
    _, costs = count_costs(torch.matmul, torch.randn(32, 48),
                           torch.randn(48, 16))
    assert costs.memory_bytes >= 4 * (32 * 48 + 48 * 16 + 32 * 16)


@pytest.fixture
def fake_world():
    """A fake process group of 4 ranks in this process (rank 0), ended
    after the test so no later test sees it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        pytest.skip("a process group is already running here")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (4,))
    finally:
        dist.destroy_process_group()


def test_collectives_counted_with_bytes(fake_world):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = distribute_tensor(torch.randn(64, 32), fake_world, [Shard(0)],
                          src_data_rank=None)
    w = distribute_tensor(torch.randn(32, 16), fake_world, [Replicate()],
                          src_data_rank=None)

    def f(x, w):
        return (x @ w).redistribute(fake_world, [Replicate()])

    _, costs = count_costs(f, x, w)
    # The all-gather's output is the full (64, 16) f32 result.
    assert costs.collective_by_kind == {"all-gather": 64 * 16 * 4}
    assert costs.collective_counts == {"all-gather": 1}
    assert costs.collective_bytes == 64 * 16 * 4
    # Local product: (16, 32) @ (32, 16) on this rank.
    assert costs.flops == 2 * 16 * 32 * 16


def test_dtensor_product_counts_local_flops_only(fake_world):
    """(64, 128) @ (128, 256) with the right operand Shard(1) over 4 ranks:
    each device multiplies (64, 128) @ (128, 64), 1,048,576 FLOPs, the
    reference's per-device count.  Torch's FlopCounterMode reports the
    global op's 4,194,304 here, and a mode that also counted DTensor's
    shape propagation would report 5,242,880; under an outer
    FakeTensorMode (the dry run's) the propagation runs in that mode."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    a = distribute_tensor(torch.randn(64, 128), fake_world, [Replicate()],
                          src_data_rank=None)
    b = distribute_tensor(torch.randn(128, 256), fake_world, [Shard(1)],
                          src_data_rank=None)
    _, costs = count_costs(torch.matmul, a, b)
    assert costs.flops == 1_048_576
    assert costs.memory_bytes == 4 * (64 * 128 + 128 * 64 + 64 * 64)

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        torch.matmul(a, b)
    assert fc.get_total_flops() != 1_048_576
    with FakeTensorMode():
        fa, fb = (distribute_tensor(torch.empty(t.shape), fake_world,
                                    t.placements, src_data_rank=None)
                  for t in (a, b))
        _, fake = count_costs(torch.matmul, fa, fb)
    assert fake.flops == 1_048_576


def test_fake_tensors_are_counted():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a, b = torch.empty(1024, 2048), torch.empty(2048, 512)
        _, costs = count_costs(torch.matmul, a, b)
    assert costs.flops == 2 * 1024 * 2048 * 512


def test_conv_flops():
    x, w = torch.randn(2, 8, 16, 16), torch.randn(4, 8, 3, 3)
    out, costs = count_costs(torch.nn.functional.conv2d, x, w)
    assert costs.flops == 2 * out.numel() * 8 * 3 * 3

    def fwd_bwd(x, w):
        y = torch.nn.functional.conv2d(x, w)
        torch.autograd.grad(y.sum(), (x, w))

    _, both = count_costs(fwd_bwd, x.requires_grad_(), w.requires_grad_())
    # The backward's grad_input and grad_weight cost the forward's each.
    assert both.flops == 3 * costs.flops


# ---------------------------------------------------------------------------
# A dense smoke prefill against the reference's HLO count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["paper-gpt2-124m", "gemma2-9b"])
def test_prefill_flops_match_the_reference_hlo(arch):
    """The reference's prefill computes the head for every row and keeps
    the last; the port's builder computes the last row's only.  The
    port's full-row forward is held to the reference within 2%, and the
    builder is the forward less the head's other rows, exactly."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.params import init_params
    from repro.models.partitioning import AxisRules
    from repro.models.registry import get_smoke_config as ref_smoke
    from repro.roofline.hlo_parse import parse_hlo_costs
    from repro.train.step import make_prefill_step as ref_prefill

    from repro_torch.models.params import params_from_numpy
    from repro_torch.models.registry import get_smoke_config
    from repro_torch.train.step import make_prefill_step

    b, s = 2, 64
    rc = dataclasses.replace(ref_smoke(arch), dtype="float32")
    w = init_params(rc, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, rc.vocab, (b, s))
    hlo = jax.jit(ref_prefill(rc, AxisRules(rules={}, mesh_axes=()), s)).lower(
        w, {"tokens": jnp.asarray(toks, jnp.int32)}).compile().as_text()
    want = parse_hlo_costs(hlo).flops

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, w),
                               device="cpu")
    tokens = torch.from_numpy(toks)
    with torch.no_grad():
        _, fwd = count_costs(M.forward, cfg, params, tokens,
                             mode="prefill", cache_len=s)
        _, step = count_costs(make_prefill_step(cfg, None, s), params,
                              {"tokens": tokens})
    assert abs(fwd.flops - want) <= FLOP_TOL * want, (fwd.flops, want)
    head_rows = 2.0 * b * (s - 1) * cfg.d_model * cfg.vocab_padded
    assert step.flops == fwd.flops - head_rows


def test_roofline_report_equals_the_reference(monkeypatch):
    pytest.importorskip("jax")
    import repro.roofline.analysis as ref_analysis
    from repro.models.config import SHAPES as REF_SHAPES
    from repro.models.registry import get_config as ref_config
    from repro.roofline.hlo_parse import ModuleCosts as RefCosts

    fields = dict(flops=3.1e15, memory_bytes=7.7e11, collective_bytes=2.5e10,
                  collective_by_kind={"all-gather": 2.0e10,
                                      "all-reduce": 5.0e9},
                  collective_counts={"all-gather": 12, "all-reduce": 3},
                  while_trip_counts={})
    monkeypatch.setattr(ref_analysis, "parse_hlo_costs",
                        lambda _: RefCosts(**fields))
    for arch, shape_name in (("gemma2-9b", "train_4k"),
                             ("deepseek-v2-236b", "decode_32k"),
                             ("falcon-mamba-7b", "prefill_32k")):
        cfg, rcfg = get_config(arch), ref_config(arch)
        kw = dict(arch=arch, mesh_name="pod16x16", chips=256,
                  cost_analysis={"flops": 1.0, "utilization": 2.0},
                  params=cfg.param_count(),
                  active_params=cfg.active_param_count(), note="n")
        got = roofline_report(shape=SHAPES[shape_name], cfg=cfg,
                              costs=ModuleCosts(**fields), **kw)
        want = ref_analysis.roofline_report(
            shape=REF_SHAPES[shape_name], cfg=rcfg, hlo_text="", **kw)
        assert got.as_dict() == want.as_dict()
        assert got.as_dict()["dominant"] == "compute"
