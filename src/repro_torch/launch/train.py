"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cpu] [--mesh host|prod]`` (counterpart of
src/repro/launch/train.py).

The card unless ``--device cpu``: seeded params, the microbatched,
remat'd train step, the deterministic data pipeline, async checkpoints
every ``--ckpt-every`` steps, restart under the supervisor and the
straggler monitor.  ``--mesh host`` (the 1x1 host mesh, a 1-rank
process group the launcher starts) or ``--mesh prod`` (16x16, in a world
of 256 ranks the caller started) shards the parameters by
``param_pspecs`` and the moments by ``opt_state_pspecs`` as DTensors;
without ``--mesh`` the step runs on plain tensors.  Frontend stubs get
zeros: ``vision_embeds`` for a VLM, ``encoder_frames`` for an
encoder-decoder, as the reference feeds them.

:func:`run` is the loop ``main``, ``examples_torch/train_lm.py`` and
``chip_smoke.py`` share.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import tempfile
import time
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.launch import mesh as meshes
from repro_torch.models.params import count_params, init_params, param_pspecs
from repro_torch.models.partitioning import distribute_tree, make_rules
from repro_torch.models.registry import get_config, get_smoke_config
from repro_torch.optim.adamw import adamw_init, opt_state_pspecs
from repro_torch.runtime.heartbeat import StepMonitor
from repro_torch.runtime.supervisor import Supervisor
from repro_torch.train.step import TrainHParams, make_train_step

__all__ = ["build_trainer", "TrainRun", "run", "main"]


def build_trainer(cfg: ModelConfig, hp: TrainHParams, *, mesh=None,
                  seed: int = 0, device="cuda"):
    """``(params, opt_state, train_step)``: weights drawn from a generator
    seeded with ``seed`` on ``device`` (the card unless ``device="cpu"``;
    raises without a GPU otherwise) and zeroed float32 moments.  With a
    ``mesh`` (a DeviceMesh with the reference's axis names) every rank
    draws the same weights and keeps its shard: the parameters are
    DTensors laid out by ``param_pspecs``, the moments by
    ``opt_state_pspecs`` (ZeRO-1), and the step is the sharded one
    (src/repro/launch/train.py:31-53)."""
    dev = resolve_device(device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    if mesh is None:
        return params, adamw_init(params), make_train_step(cfg, hp)
    rules = make_rules(mesh, fsdp=cfg.fsdp, n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads)
    p_specs = param_pspecs(cfg, rules)
    o_specs = opt_state_pspecs(p_specs, params,
                               rules.axis_sizes.get("data", 1))
    params = distribute_tree(mesh, params, p_specs)
    opt = adamw_init(params, mesh=mesh, specs=o_specs)
    return params, opt, make_train_step(cfg, hp, rules=rules)


@dataclasses.dataclass
class TrainRun:
    """What :func:`run` saw.  ``history`` holds ``(step, loss, seconds)``
    for every step run, replays included, in order; ``batches`` the
    ``(step, digest)`` of each batch fed; ``losses`` the last loss of each
    step index."""

    state: dict
    supervisor: Supervisor
    monitor: StepMonitor
    history: list = dataclasses.field(default_factory=list)
    batches: list = dataclasses.field(default_factory=list)

    @property
    def losses(self) -> dict[int, float]:
        return {step: loss for step, loss, _ in self.history}


def _digest(batch: dict) -> str:
    h = hashlib.sha1()
    for k in sorted(batch):
        h.update(batch[k].tobytes())
    return h.hexdigest()


def run(
    cfg: ModelConfig,
    hp: TrainHParams,
    *,
    batch: int,
    seq: int,
    steps: int,
    ckpt_dir: str,
    ckpt_every: int = 20,
    log_every: int = 10,
    device="cuda",
    mesh=None,
    data_vocab: int | None = None,
    failure_hook: Callable[[int], None] | None = None,
    log: Callable[[str], None] = print,
) -> TrainRun:
    """Train ``steps`` steps under the :class:`Supervisor` (the last 2
    checkpoints kept) from a fresh :func:`build_trainer`: each step's
    batch is
    ``SyntheticLMDataset``'s (data seed 0, as the reference's) for its
    index (so a replay after a restore sees the same stream),
    moved to the device, with the frontend stubs' zeros.  ``data_vocab``
    draws the stream's tokens from the first ``data_vocab`` ids only
    (default: the whole vocabulary, as the reference).  The loss is read
    on the host every step, as the reference does.  ``mesh``: the sharded
    trainer of :func:`build_trainer`."""
    params, opt, step_fn = build_trainer(cfg, hp, mesh=mesh, device=device)
    dev, dt = params["embed"].device, params["embed"].dtype
    data = SyntheticLMDataset(data_vocab or cfg.vocab, seq, batch)
    out = TrainRun(
        state={"params": params, "opt": opt},
        supervisor=Supervisor(CheckpointManager(ckpt_dir, keep_n=2),
                              ckpt_every=ckpt_every),
        monitor=StepMonitor(),
    )

    def one_step(state, step):
        t0 = time.perf_counter()
        host = data.batch_at(step)
        out.batches.append((step, _digest(host)))
        b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        if cfg.vision_prefix:
            b["vision_embeds"] = torch.zeros(
                (batch, cfg.vision_prefix, cfg.d_model), dtype=dt, device=dev)
        if cfg.encoder_decoder:
            b["encoder_frames"] = torch.zeros(
                (batch, cfg.encoder_seq, cfg.d_model), dtype=dt, device=dev)
        params, opt, metrics = step_fn(state["params"], state["opt"], b)
        loss = float(metrics["loss"])
        secs = time.perf_counter() - t0
        out.monitor.record(0, step, secs)
        out.history.append((step, loss, secs))
        if step % log_every == 0:
            log(f"step {step:5d}  loss {loss:.4f}  "
                f"lr {float(metrics['lr']):.2e}  ({secs:.3f}s)")
        return {"params": params, "opt": opt}

    out.state = out.supervisor.run(out.state, one_step, num_steps=steps,
                                   failure_hook=failure_hook)
    return out


def main(argv: list[str] | None = None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-gpt2-124m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--mesh", choices=("host", "prod"), default=None,
                    help="shard over the 1x1 host mesh or the 16x16 "
                         "production mesh (default: no mesh)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a temporary directory, removed at exit")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    hp = TrainHParams(
        base_lr=args.lr,
        warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps,
        num_microbatches=args.microbatches,
    )
    mesh = None
    if args.mesh == "host":
        mesh = meshes.make_host_mesh(device=dev)
    elif args.mesh == "prod":
        mesh = meshes.make_production_mesh(device=dev)
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh else None
    print(f"arch={cfg.name} params={count_params(cfg):,} device={dev} "
          f"mesh={shape}")
    try:
        with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt-") as tmp:
            t0 = time.perf_counter()
            res = run(cfg, hp, batch=args.batch, seq=args.seq,
                      steps=args.steps, ckpt_dir=args.ckpt_dir or tmp,
                      ckpt_every=args.ckpt_every, log_every=args.log_every,
                      device=dev, mesh=mesh)
    finally:
        meshes.destroy()
    st = res.supervisor.stats
    print(f"done: {st.steps_run} steps in {time.perf_counter() - t0:.1f}s; "
          f"failures={st.failures} restores={st.restores}; "
          f"stragglers={res.monitor.stragglers()}")
    return res


if __name__ == "__main__":
    main()
