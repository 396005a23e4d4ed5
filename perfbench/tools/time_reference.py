#!/usr/bin/env python3
"""Time the plain reference a configuration file names on the card: the
weights drawn from a seed as a run's judge draws them, then one sequence
teacher-forced through the reference in float32 and through its float8
control, each with its seconds and the card's peak bytes.  For sizing a
cell whose judge runs this reference after every run's window.

    python3 perfbench/tools/time_reference.py \
        --config perfbench/tools/jamba2-mini-period.json \
        --tokens 4096 --prompt 1024 --seed 2147483800

The last line of standard output is one JSON object of the readings.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--tokens", type=int, default=4096)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    sys.path.insert(0, PB)
    import torch

    from kit import judge, weights

    if not torch.cuda.is_available():
        print("time_reference: needs a CUDA device", file=sys.stderr)
        return 2
    with open(args.config) as f:
        conf = json.load(f)
    model, plain = conf["model"], judge.reference_for(conf)
    out = {"config": conf["name"], "reference": plain.__name__,
           "tokens": args.tokens, "prompt": args.prompt, "card": _card(),
           "weight_bytes": weights.nbytes(model)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ws = weights.draw(model, args.seed, "cuda")
    torch.cuda.synchronize()
    out["draw_s"] = time.perf_counter() - t0
    out["draw_peak_bytes"] = torch.cuda.max_memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    toks = torch.randint(0, model["vocab"], (args.tokens,), generator=gen,
                         device="cuda")
    for fmt in ("f32", "fp8"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits = plain.logits(ws, model, toks, args.prompt, args.prompt,
                              weight_fmt=fmt)
        torch.cuda.synchronize()
        out[f"{fmt}_s"] = time.perf_counter() - t0
        out[f"{fmt}_peak_bytes"] = torch.cuda.max_memory_allocated()
        out[f"{fmt}_positions"] = int(logits.shape[0])
        out[f"{fmt}_finite"] = bool(torch.isfinite(logits).all())
        del logits
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
