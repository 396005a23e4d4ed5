"""Multi-pod dry run: every (arch x shape) cell on the production meshes,
with no chips, and the roofline terms (counterpart of
src/repro/launch/dryrun.py).

Run it as its own process (``python -m repro_torch.launch.dryrun``): it
starts a world of torch's "fake" process group (``FakeStore``), one
process that is rank 0 of 256 ranks (the 16x16 mesh) or 512 (2x16x16).
Collectives on it return at once and move nothing, so the mesh, the
DTensor layouts and every rank-0 shard are real while no data moves.

For each cell:

* the parameter, cache and optimizer trees as meta tensors and their
  PartitionSpecs (``param_pspecs``, ``cache_pspecs``,
  ``opt_state_pspecs(zero1=True)``), and the step built for the cell
  (``make_train_step(grad_pspecs=)``, ``make_prefill_step``,
  ``make_decode_step``); ``state_bytes_per_device`` is the reference's
  analytic sum (roofline/memory.py);
* unless ``--no-compile``, the counting half: the step runs once under
  ``FakeTensorMode`` on DTensor parameters, caches and inputs laid out by
  those specs, under the op counter (roofline/op_counts.py), which fills
  the ``roofline`` entry at the reference's default chip; and
  ``memory_analysis`` from torch's ``MemTracker``, or ``{"error": ...}``
  where it does not run under fake tensors (the reference records the
  same where its backend lacks ``memory_analysis``).

Where the reference lowers and compiles with XLA, the port has nothing
to compile: a step is the Python that dispatches its ops, so
``lower_seconds`` is the time to build the trees and the step, and
``compile_seconds`` the time of the counted run.  A cell that fails
records its error and the sweep goes on; results go to a JSON file
written after every cell, so a long sweep resumes.  ``--groups N`` counts
a model cut to N layer groups (every width kept; the state bytes stay
the full model's), for quick checks.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES, ModelConfig, ShapeSpec
from repro_torch.models.params import (
    abstract_params,
    count_params,
    param_pspecs,
)
from repro_torch.models.partitioning import (
    distribute_tree,
    make_rules,
    replicated_ops,
)
from repro_torch.models.registry import (
    ASSIGNED_ARCH_IDS,
    cell_supported,
    get_config,
)
from repro_torch.optim.adamw import adamw_init, opt_state_pspecs
from repro_torch.roofline.analysis import V5E, roofline_report
from repro_torch.roofline.memory import tree_device_bytes
from repro_torch.roofline.op_counts import OpCounter
from repro_torch.train.step import (
    TrainHParams,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    serve_input_specs,
    shard_batch,
    train_input_specs,
)

__all__ = ["lower_cell", "fake_world", "main", "DEFAULT_OUT"]

DEFAULT_OUT = "results/dryrun_torch.json"


def _microbatches(cfg: ModelConfig, shape: ShapeSpec, dp_extent: int) -> int:
    """Gradient-accumulation factor: keep the per-microbatch logits block
    (mb x seq x vocab) and MoE dispatch buffers inside the HBM budget,
    while the per-microbatch batch still covers every DP shard (a smaller
    microbatch would replicate compute across part of the mesh)."""
    if shape.kind != "train":
        return 1
    mb = 8
    # Very large vocab: accumulate more (the f32 logits block dominates).
    if cfg.vocab >= 200000:
        mb = 16
    mb = min(mb, max(shape.global_batch // max(dp_extent, 1), 1))
    while shape.global_batch % mb:
        mb //= 2
    return max(mb, 1)


def fake_world(world_size: int) -> None:
    """Make this process rank 0 of a fake world of ``world_size`` ranks,
    replacing a fake world of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


@contextlib.contextmanager
def _strided_shards_outside_fake():
    """DTensor computes a strided shard's indices with a small index
    tensor and ``.tolist()`` (placement_types.py), which FakeTensorMode
    refuses as data-dependent; those indices depend on the layout alone,
    so they are computed with fake mode lifted."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt

    cls = getattr(pt, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def lifted(self, *args, **kwargs):
        with unset_fake_temporarily():
            return orig(self, *args, **kwargs)

    cls.local_shard_size_and_offset = lifted
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def _plain_tree(tree):
    """A meta tree's leaves as empty tensors of the current (fake) mode."""
    if torch.is_tensor(tree):
        return torch.empty(tree.shape, dtype=tree.dtype)
    return {k: _plain_tree(v) for k, v in tree.items()}


@contextlib.contextmanager
def _mem_tracker(out: dict):
    """Track memory with torch's ``MemTracker`` around the block and fill
    ``out`` with its peak per device and kind, or with the error (as the
    reference records a backend without ``memory_analysis``)."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker

        mt = MemTracker()
        mt.__enter__()
    except Exception as e:  # noqa: BLE001 (recorded, as the reference)
        out["error"] = f"{type(e).__name__}: {e}"
        yield
        return
    try:
        yield
    finally:
        mt.__exit__(None, None, None)
    try:
        for dev, kinds in mt.get_tracker_snapshot("peak").items():
            for k, v in kinds.items():
                out[f"{dev}/{getattr(k, 'value', k)}"] = int(v)
    except Exception as e:  # noqa: BLE001
        out.clear()
        out["error"] = f"{type(e).__name__}: {e}"


def _count(kind, cfg, shape, mesh, rules, p_specs, extra,
           memory: bool = True) -> tuple:
    """Run the cell's step once on fake DTensors under the op counter:
    ``(ModuleCosts, op-name counts, memory_analysis, seconds)``; with
    ``memory`` once more under the memory tracker (else
    ``memory_analysis`` is empty)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(), _strided_shards_outside_fake():
        params = distribute_tree(mesh, _plain_tree(abstract_params(cfg)),
                                 p_specs)
        b, s = shape.global_batch, shape.seq_len
        if kind == "train":
            opt = adamw_init(params, mesh=mesh, specs=extra["o_specs"])
            batch = _plain_tree(train_input_specs(cfg, shape, rules)[0])

            def run():
                return extra["step"](params, opt, batch)
        elif kind == "prefill":
            batch = shard_batch(
                _plain_tree(serve_input_specs(cfg, shape, rules)[0]), rules)

            def run():
                with torch.no_grad(), replicated_ops():
                    return extra["step"](params, batch)
        else:
            cache = distribute_tree(mesh, M.make_cache(cfg, b, s, "cpu"),
                                    extra["c_specs"])
            tokens = shard_batch({"tokens": torch.zeros(
                (b, 1), dtype=torch.int32)}, rules)["tokens"]

            def run():
                with torch.no_grad(), replicated_ops():
                    return extra["step"](params, cache, tokens, s - 1)

        t0 = time.perf_counter()
        with OpCounter() as counter:
            run()
        seconds = time.perf_counter() - t0
        # A second run of its own: over the counter, the tracker would see
        # the global DTensor ops instead of the rank's local ones.
        mem: dict = {}
        if memory:
            with _mem_tracker(mem):
                run()
    return counter.costs(), dict(counter.op_names), mem, seconds


def lower_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool,
    do_compile: bool = True,
    groups: int | None = None,
    memory: bool = True,
) -> dict:
    """One cell's record (the reference's keys); ``do_compile=False``
    stops after the state bytes.  ``groups`` cuts the counted model to
    that many layer groups.  ``memory=False`` skips the memory tracker's
    run of the step, about 40% of a cell's time, for a caller that reads
    only the counts (``memory_analysis`` is then empty)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    chips = 512 if multi_pod else 256
    fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rules = make_rules(
        mesh, fsdp=cfg.fsdp, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads
    )
    axis_sizes = dict(rules.axis_sizes)
    run_cfg = cfg if groups is None else dataclasses.replace(
        cfg, n_layers=len(cfg.pattern) * groups,
        n_encoder_layers=min(cfg.n_encoder_layers, groups))

    params = abstract_params(cfg)
    p_specs = param_pspecs(cfg, rules)

    t0 = time.perf_counter()
    extra: dict = {}
    if shape.kind == "train":
        dp_extent = axis_sizes.get("data", 1) * axis_sizes.get("pod", 1)
        hp = TrainHParams(
            num_microbatches=_microbatches(cfg, shape, dp_extent)
        )
        opt = adamw_init(params)
        o_specs = opt_state_pspecs(
            p_specs, params, axis_sizes.get("data", 1), zero1=True
        )
        state_bytes = (
            tree_device_bytes(params, p_specs, axis_sizes)
            + tree_device_bytes(opt["mu"], o_specs["mu"], axis_sizes)
            + tree_device_bytes(opt["nu"], o_specs["nu"], axis_sizes)
            + tree_device_bytes(params, p_specs, axis_sizes)  # grads
        )
        run_specs = param_pspecs(run_cfg, rules)
        extra["o_specs"] = opt_state_pspecs(
            run_specs, abstract_params(run_cfg), axis_sizes.get("data", 1),
            zero1=True)
        extra["step"] = make_train_step(run_cfg, hp, rules=rules,
                                        grad_pspecs=run_specs)
    else:
        b, s = shape.global_batch, shape.seq_len
        c_specs = M.cache_pspecs(cfg, rules, b, s)
        cache = M.abstract_cache(cfg, b, s)
        state_bytes = (
            tree_device_bytes(params, p_specs, axis_sizes)
            + tree_device_bytes(cache, c_specs, axis_sizes)
        )
        extra["c_specs"] = M.cache_pspecs(run_cfg, rules, b, s)
        builder = (make_prefill_step if shape.kind == "prefill"
                   else make_decode_step)
        extra["step"] = builder(run_cfg, rules, cache_len=s)

    lower_s = time.perf_counter() - t0
    result: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": chips,
        "params": count_params(cfg),
        "active_params": cfg.active_param_count(),
        "state_bytes_per_device": state_bytes,
        "state_gib_per_device": state_bytes / 2**30,
        "lower_seconds": lower_s,
    }
    if not do_compile:
        return result

    costs, op_names, mem, seconds = _count(
        shape.kind, run_cfg, shape, mesh, rules, param_pspecs(run_cfg, rules),
        extra, memory)
    result["compile_seconds"] = seconds
    result["memory_analysis"] = mem
    report = roofline_report(
        arch=arch,
        shape=shape,
        mesh_name=mesh_name,
        chips=chips,
        costs=costs,
        cost_analysis=None,
        cfg=run_cfg,
        params=count_params(run_cfg),
        active_params=run_cfg.active_param_count(),
        chip=V5E,
        note="" if groups is None else f"counted at groups={groups}",
    )
    result["roofline"] = report.as_dict()
    result["collective_counts"] = dict(costs.collective_counts)
    result["op_names"] = op_names
    result["ops_dispatched"] = sum(op_names.values())
    return result


def main(argv: list[str] | None = None) -> int:
    """The sweep; returns the number of failed cells (the process exits
    0 either way, as the reference's does)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument(
        "--mesh", choices=["single", "multi", "both"], default="both"
    )
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-compile", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells already in the results file")
    ap.add_argument("--groups", type=int, default=None,
                    help="count a model cut to this many layer groups")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh
    ]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results: dict[str, dict] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    t_all = time.perf_counter()
    n_fail = 0
    for multi in meshes:  # one fake world per mesh
        for arch in archs:
            for shape_name in shapes:
                ok, reason = cell_supported(arch, shape_name)
                key = f"{arch}|{shape_name}|{'multi' if multi else 'single'}"
                if key in results and not args.force and (
                    "error" not in results[key]
                ):
                    continue
                if not ok:
                    results[key] = {
                        "arch": arch, "shape": shape_name,
                        "mesh": "pod2x16x16" if multi else "pod16x16",
                        "skipped": reason,
                    }
                    print(f"[skip] {key}: {reason}")
                else:
                    print(f"[cell] {key} ...", flush=True)
                    try:
                        t0 = time.perf_counter()
                        results[key] = lower_cell(
                            arch, shape_name, multi_pod=multi,
                            do_compile=not args.no_compile,
                            groups=args.groups,
                        )
                        dt = time.perf_counter() - t0
                        r = results[key].get("roofline", {})
                        print(
                            f"       ok in {dt:.1f}s  dominant="
                            f"{r.get('dominant')}  state/dev="
                            f"{results[key]['state_gib_per_device']:.2f}GiB",
                            flush=True,
                        )
                    except Exception as e:  # noqa: BLE001 (recorded)
                        n_fail += 1
                        results[key] = {
                            "arch": arch, "shape": shape_name,
                            "mesh": "pod2x16x16" if multi else "pod16x16",
                            "error": f"{type(e).__name__}: {e}"[:2000],
                            "traceback": traceback.format_exc()[-2000:],
                        }
                        print(f"       FAILED: {str(e)[:300]}", flush=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"done in {time.perf_counter() - t_all:.1f}s; {n_fail} failures; "
          f"results in {args.out}")
    return n_fail


if __name__ == "__main__":
    main()
