"""Where a training step's time goes: paper-gpt2-124m at full width and
depth, one step of the launcher's defaults (batch 8 x seq 128, 2
microbatches, remat), on the card.

Per variant: the step's host wall-clock (synchronized, best of
``--steps``), the device time of every kernel in it (``torch.profiler``,
CUDA activity) and the host operators that take the most CPU time.  The device's busy share of a step is its summed kernel
time over its wall-clock; the aten operators a step runs count its
eager dispatches.  Variants beside the default: one microbatch
of 8 rows, and no remat (each group's activations kept; the loss
function's ``remat=False``).

    python benchmarks_torch/trace_train.py --json train.json
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from benchmarks_torch.util import card_line  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.launch.train import build_trainer  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402
from repro_torch.train.step import TrainHParams  # noqa: E402

VARIANTS = (("default", 2, True), ("one_microbatch", 1, True),
            ("no_remat", 2, False))


def profile_step(step, steps: int) -> dict:
    """Best host wall-clock of ``steps`` synchronized steps, then one
    profiled window of ``steps`` steps: per step, the device µs and
    launches of each kernel (CUDA-side events only: autograd's host
    ranges also carry device time, which would count it twice) and the
    host µs and count of each aten operator."""
    from torch.autograd import DeviceType

    best = float("inf")
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
            torch.cuda.synchronize()
    kernels, ops = {}, {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            kernels[evt.key] = {"us": evt.self_device_time_total / steps,
                                "count": evt.count / steps}
        elif evt.key.startswith("aten::"):
            ops[evt.key] = {"self_us": evt.self_cpu_time_total / steps,
                            "count": evt.count / steps}
    busy = sum(v["us"] for v in kernels.values())
    return {"wall_us": best * 1e6, "device_us": busy,
            "busy_share": busy / (best * 1e6),
            "launches": sum(v["count"] for v in kernels.values()),
            "kernels": kernels, "ops": ops}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_train: no CUDA device", file=sys.stderr)
        return 1
    card = card_line("cuda")
    cfg = get_config("paper-gpt2-124m")
    data = SyntheticLMDataset(cfg.vocab, 128, 8)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch_at(0).items()}
    out = {"card": card, "arch": cfg.name, "batch": 8, "seq": 128}
    for name, mb, remat in VARIANTS:
        train_step.loss_fn = functools.partial(model.loss_fn, remat=remat)
        hp = TrainHParams(base_lr=3e-4, warmup_steps=5, total_steps=50,
                          num_microbatches=mb)
        params, opt, step = build_trainer(cfg, hp, device="cuda")
        torch.cuda.reset_peak_memory_stats()

        def one(params=params, opt=opt, step=step):
            step(params, opt, batch)

        one()
        r = profile_step(one, args.steps)
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[name] = r
        del params, opt, step
        torch.cuda.empty_cache()
    train_step.loss_fn = model.loss_fn
    for name, _, _ in VARIANTS:
        r = out[name]
        print(f"{name}: step {r['wall_us'] / 1e3:.2f} ms host wall-clock, "
              f"{r['device_us'] / 1e3:.2f} ms of kernels in "
              f"{r['launches']:.0f} launches, busy share "
              f"{r['busy_share']:.3f}, peak_gb {r['peak_gb']:.3f} on {card}")
        top = sorted(r["kernels"].items(), key=lambda kv: -kv[1]["us"])
        for k, v in top[:8]:
            print(f"  kernel {k[:64]:64s} {v['us']:9.1f} us "
                  f"x{v['count']:.0f}")
        top = sorted(r["ops"].items(), key=lambda kv: -kv[1]["self_us"])
        for k, v in top[:10]:
            print(f"  host op {k:36s} {v['self_us']:9.1f} us self "
                  f"x{v['count']:.0f} a step")
        print(f"  aten ops a step: "
              f"{sum(v['count'] for v in r['ops'].values()):.0f}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1, sort_keys=True))
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
