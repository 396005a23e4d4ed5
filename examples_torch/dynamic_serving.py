"""Continuous-batched LM serving with Vortex bucketing (the PyTorch
counterpart of examples/dynamic_serving.py, driving the scheduler).

    PYTHONPATH=src python examples_torch/dynamic_serving.py               # GPU
    PYTHONPATH=src python examples_torch/dynamic_serving.py --device cpu  # smoke

A stream of requests with random batch sizes, prompt lengths and output
lengths is submitted to a ``ContinuousScheduler`` over a ``VortexServer``:
each request is prefilled at its (batch, seq) bucket, then every active row
advances in one mixed-progress decode step per token, rows at different
positions sharing the step.  The script prints each request's output shape,
the steps and rows per step, the bucket counters, and checks a few requests
against the serial ``generate()`` path.  On the CPU (``--device cpu``) it
serves the smoke config with the kernels' plain versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.launch.scheduler import ContinuousScheduler
from repro_torch.launch.serve import Request, VortexServer
from repro_torch.models.registry import get_config, get_smoke_config


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-gpt2-124m")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (the default on the CPU)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch-rows", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    smoke = args.smoke or torch.device(args.device).type == "cpu"
    cfg = get_smoke_config(args.arch) if smoke else get_config(args.arch)
    server = VortexServer(cfg, max_cache=256, seed=args.seed,
                          device=args.device)
    sched = ContinuousScheduler(server, batch_rows=args.batch_rows)
    rng = np.random.default_rng(args.seed)

    reqs = []
    for _ in range(args.requests):
        b = int(rng.integers(1, 5))
        s = int(rng.integers(4, 120))
        reqs.append(Request(
            tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int64),
            max_new=int(rng.integers(4, 17)),
        ))
    t0 = time.perf_counter()
    rids = [sched.submit(r) for r in reqs]
    res = sched.drain()
    dt = time.perf_counter() - t0
    steps = sched.stats["steps"]
    for i, (rid, r) in enumerate(zip(rids, reqs)):
        print(f"req {i:2d}: tokens {r.tokens.shape} max_new {r.max_new:2d} "
              f"-> {res[rid].shape}")
    tokens = sum(res[rid].size for rid in rids)
    print(f"\n{len(reqs)} requests, {tokens} tokens in {dt:.2f}s on "
          f"{server.device} ({cfg.name}): {steps} decode steps, "
          f"{sched.stats['rows_stepped'] / max(steps, 1):.2f} rows a step, "
          f"prefill buckets "
          f"{server.stats['prefill_buckets']}, decode buckets "
          f"{server.stats['decode_buckets']}")
    sched.close()
    print(f"kv pool: {server.kv_pool.stats()}")

    same = all(
        np.array_equal(res[rid], server.generate(r))
        for rid, r in list(zip(rids, reqs))[:3]
    )
    print(f"first 3 requests token-identical to serial generate(): {same}")


if __name__ == "__main__":
    main()
