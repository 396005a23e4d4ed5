"""Where a decode step's time goes: paper-gpt2-124m at full width, one
step eager (``VortexServer(graphs=False)``) against one replay of its CUDA
graph, on the card.

Per form: the step's host wall-clock (synchronized, best of ``--steps``),
the device time of every kernel in it (``torch.profiler``, CUDA
activity), and for the eager step the host operators that take the most
CPU time.  The device's busy share of a step is its summed kernel time
over the step's wall-clock.

    python benchmarks_torch/trace_decode.py --json decode.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks_torch.util import card_line  # noqa: E402
from repro_torch.launch.serve import VortexServer  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_step(step, steps: int) -> dict:
    """Best host wall-clock of ``steps`` synchronized steps, then one
    profiled window of ``steps`` steps: device µs per step by kernel and
    host µs per step by operator."""
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
        dev = _device_us(evt)
        if dev and not evt.key.startswith(("aten::", "cuda", "Activity")):
            kernels[evt.key] = dev / steps
        if evt.key.startswith("aten::"):
            ops[evt.key] = {"self_us": evt.self_cpu_time_total / steps,
                            "count": evt.count / steps}
    busy = sum(kernels.values())
    return {"wall_us": best * 1e6, "device_us": busy,
            "busy_share": busy / (best * 1e6), "kernels": kernels,
            "ops": ops}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_decode: no CUDA device", file=sys.stderr)
        return 1
    card = card_line("cuda")
    cfg = get_config("paper-gpt2-124m")
    graphed = VortexServer(cfg, max_cache=256, seed=0)
    eager = VortexServer(cfg, max_cache=256, params=graphed.params,
                         graphs=False)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 120))
    out = {"card": card, "arch": cfg.name, "batch": 2, "prompt": 120}
    for name, srv in (("eager", eager), ("graphed", graphed)):
        tok, cache, _ = srv.prefill(toks)
        t = tok[:, None]

        def step(srv=srv, cache=cache, t=t):
            # The same position every step: the step is idempotent.
            return srv._decode(cache, t, 120, srv._decode_seen)

        step()  # the graph's capture, the executables' first build
        out[name] = profile_step(step, args.steps)
        srv.release_cache(cache)
    for name in ("eager", "graphed"):
        r = out[name]
        print(f"{name}: step {r['wall_us']:.1f} us host wall-clock, "
              f"{r['device_us']:.1f} us of kernels, busy share "
              f"{r['busy_share']:.3f} on {card}")
        for k, v in sorted(r["kernels"].items(), key=lambda kv: -kv[1])[:8]:
            print(f"  kernel {k[:70]:70s} {v:8.2f} us")
    top = sorted(out["eager"]["ops"].items(),
                 key=lambda kv: -kv[1]["self_us"])[:15]
    for k, v in top:
        print(f"  eager host op {k:32s} {v['self_us']:8.2f} us self "
              f"x{v['count']:.0f} a step")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1, sort_keys=True))
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
