"""The port's dry run (launch/dryrun.py) against the JAX package's:

* ``all_cells``/``cell_supported`` equal to the reference's (40 cells,
  ``long_500k`` skipped with the same reason for every arch that is not
  sub-quadratic) and ``_microbatches`` equal for every cell (the
  reference's function is read from its source: importing its module
  would set XLA_FLAGS for 512 host devices in this process);
* in subprocesses on fake worlds of 256 and 512 ranks, each under its own
  300 s limit and run at once:

  - ``main(--no-compile --mesh both)``: every cell on both meshes with 0
    failures, the reference's skips, and each ``state_bytes_per_device``
    exactly the reference's analytic value;
  - the counting half for one decode and one prefill cell (gemma2-9b)
    and one train cell (deepseek-v2-236b), each counted at one layer
    group (``groups=1``): a ``roofline`` entry whose three terms are
    positive and whose ``dominant`` term is named.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch.models.config import SHAPES
from repro_torch.models.registry import (
    all_cells,
    cell_supported,
    get_config,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
COUNTED = (("gemma2-9b", "decode_32k"), ("gemma2-9b", "prefill_32k"),
           ("deepseek-v2-236b", "train_4k"))
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_microbatches():
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "_microbatches")
    ns = {"ModelConfig": object, "ShapeSpec": object}
    exec(compile(ast.Module([fn], []), "dryrun.py", "exec"), ns)
    return ns["_microbatches"]


def test_cells_equal_the_reference():
    pytest.importorskip("jax")
    from repro.models.registry import all_cells as ref_cells
    from repro.models.registry import cell_supported as ref_supported

    assert all_cells() == ref_cells()
    assert len(all_cells()) == 40
    for cell in all_cells():
        assert cell_supported(*cell) == ref_supported(*cell), cell
    skipped = [c for c in all_cells() if not cell_supported(*c)[0]]
    assert {s for _, s in skipped} == {"long_500k"}
    assert len(skipped) == 7


def test_microbatches_equal_the_reference():
    pytest.importorskip("jax")
    from repro.models.registry import get_config as ref_config
    from repro.models.config import SHAPES as REF_SHAPES

    from repro_torch.launch.dryrun import _microbatches

    ref = _ref_microbatches()
    for arch, shape in all_cells():
        for dp in (1, 16, 32):
            assert _microbatches(get_config(arch), SHAPES[shape], dp) == ref(
                ref_config(arch), REF_SHAPES[shape], dp), (arch, shape, dp)


_SWEEP = textwrap.dedent(
    """
    import sys
    from repro_torch.launch.dryrun import main
    sys.exit(main(["--no-compile", "--mesh", "both", "--out", sys.argv[1]]))
    """
)

_COUNT = textwrap.dedent(
    """
    import json, sys
    from repro_torch.launch.dryrun import lower_cell
    out = {}
    for cell in json.loads(sys.argv[2]):
        r = lower_cell(*cell, multi_pod=False, groups=1)
        r.pop("op_names")
        out["|".join(cell)] = r
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    """
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    jobs = [
        ([_SWEEP, str(tmp / "sweep.json")], "sweep.json"),
        ([_COUNT, str(tmp / "serve.json"), json.dumps(COUNTED[:2])],
         "serve.json"),
        ([_COUNT, str(tmp / "train.json"), json.dumps(COUNTED[2:])],
         "train.json"),
    ]
    procs = [subprocess.Popen([sys.executable, "-c", *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=str(ROOT), env=env)
             for args, _ in jobs]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    res = {}
    for _, name in jobs:
        with open(tmp / name) as f:
            res[name] = json.load(f)
    return res


def _ref_state_bytes(arch, shape_name, mesh):
    """The reference's analytic state bytes of one cell, summed as its
    lower_cell sums them (src/repro/launch/dryrun.py:103-151)."""
    import jax
    from repro.models import model as RM
    from repro.models.params import abstract_params, param_pspecs
    from repro.models.partitioning import make_rules
    from repro.models.registry import get_config as ref_config
    from repro.optim.adamw import adamw_init, opt_state_pspecs
    from repro.roofline.memory import tree_device_bytes
    from repro.models.config import SHAPES as REF_SHAPES

    shape, axes = MESHES[mesh]
    try:
        am = jax.sharding.AbstractMesh(shape, axes)
    except TypeError:
        am = jax.sharding.AbstractMesh(tuple(zip(axes, shape)))
    cfg = ref_config(arch)
    rules = make_rules(am, fsdp=cfg.fsdp, n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads)
    sizes = dict(zip(axes, shape))
    params, p_specs = abstract_params(cfg), param_pspecs(cfg, rules)
    spec = REF_SHAPES[shape_name]
    if spec.kind == "train":
        opt = adamw_init(params)
        o_specs = opt_state_pspecs(p_specs, params, sizes.get("data", 1),
                                   zero1=True)
        return (tree_device_bytes(params, p_specs, sizes)
                + tree_device_bytes(opt["mu"], o_specs["mu"], sizes)
                + tree_device_bytes(opt["nu"], o_specs["nu"], sizes)
                + tree_device_bytes(params, p_specs, sizes))
    b, s = spec.global_batch, spec.seq_len
    return (tree_device_bytes(params, p_specs, sizes)
            + tree_device_bytes(RM.abstract_cache(cfg, b, s),
                                RM.cache_pspecs(cfg, rules, b, s), sizes))


@pytest.mark.parametrize("mesh", MESHES)
def test_sweep_covers_every_cell_with_the_reference_state_bytes(runs, mesh):
    pytest.importorskip("jax")
    sweep = runs["sweep.json"]
    for arch, shape in all_cells():
        r = sweep[f"{arch}|{shape}|{mesh}"]
        assert "error" not in r, r
        ok, reason = cell_supported(arch, shape)
        if not ok:
            assert r["skipped"] == reason
            continue
        assert r["chips"] == (256 if mesh == "single" else 512)
        assert r["state_bytes_per_device"] == _ref_state_bytes(
            arch, shape, mesh), (arch, shape)


@pytest.mark.parametrize("cell", COUNTED, ids=["|".join(c) for c in COUNTED])
def test_counted_cell_has_a_roofline(runs, cell):
    arch, shape = cell
    got = runs["train.json" if shape == "train_4k" else "serve.json"]
    r = got["|".join(cell)]
    roof = r["roofline"]
    for k in ("compute_s", "memory_s", "collective_s", "flops",
              "memory_bytes", "collective_bytes"):
        assert roof[k] > 0, (k, roof[k])
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert roof["trip_counts"] == {}
    assert roof["note"] == "counted at groups=1"
    assert r["ops_dispatched"] > 0 and r["compile_seconds"] > 0
    assert "memory_analysis" in r
