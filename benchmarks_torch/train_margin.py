"""How far the loss of paper-gpt2-124m falls in a short run of the
training launcher, at a cut width or depth and on the synthetic stream
over the whole vocabulary or over its first ids only.

    PYTHONPATH=src python benchmarks_torch/train_margin.py \\
        --d-model 128 --layers 2 [--data-vocab 512] [--device cpu]

``repro_torch.launch.train.run`` at the launcher's batch (8), seq (128),
microbatches (2) and steps (50), lr ``--lr`` with 5 warmup steps; the
model is gpt2's config (vocab 50,257, bf16) with ``d_model``, heads
(d_model / 64), ``d_ff`` (4 d_model) and layers as given.  Prints the
mean of the first and the last 5 losses and their difference (the
margin), then one JSON object with them.  On the card by default;
``--device cpu`` runs the plain torch on the CPU (keep the width cut
there).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import run  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.train.step import TrainHParams  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--data-vocab", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    heads = max(args.d_model // 64, 1)
    cfg = dataclasses.replace(
        get_config("paper-gpt2-124m"), d_model=args.d_model,
        n_heads=heads, n_kv_heads=heads, d_ff=4 * args.d_model,
        n_layers=args.layers)
    hp = TrainHParams(base_lr=args.lr,
                      warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps, num_microbatches=2)
    with tempfile.TemporaryDirectory() as d:
        res = run(cfg, hp, batch=8, seq=128, steps=args.steps, ckpt_dir=d,
                  device=args.device, data_vocab=args.data_vocab)
    losses = [res.losses[i] for i in sorted(res.losses)]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"d_model={args.d_model} layers={args.layers} lr={args.lr} "
          f"data_vocab={args.data_vocab or cfg.vocab}: first5={first:.4f} "
          f"last5={last:.4f} margin={first - last:.4f}")
    print(json.dumps({"d_model": args.d_model, "layers": args.layers,
                      "lr": args.lr, "data_vocab": args.data_vocab,
                      "first5": first, "last5": last,
                      "margin": first - last}))


if __name__ == "__main__":
    main()
