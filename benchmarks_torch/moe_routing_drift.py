"""How far the kernel path and the plain path of a served MoE model drift
apart through routing, on one NVIDIA GPU.

    PYTHONPATH=src python benchmarks_torch/moe_routing_drift.py

One prompt (batch 1, 57 tokens, padded to its sequence bucket) goes
through ``prefill_step`` twice per variant: once under an engine with the
hand-written kernels (impl="cuda") and once under the plain PyTorch
versions (impl="torch"), on the same seeded weights.  For each variant it
prints the logits' max |difference| over max |plain logits| at the last
real row, and the share of (token, choice) expert assignments that differ
between the two runs, overall and per layer.  Variants:

* ``bf16`` — the served model as ``init_params`` seeds it (expert fan-in
  = each expert's input width);
* ``bf16-ref-scale`` — the expert stacks rescaled to the JAX package's
  init (fan-in = the expert count, std E^-1/2; ROADMAP C2);
* ``f32-ref-scale`` — the same weights in float32.

The card's name and power limit are printed first; the last line is one
JSON object with every number.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.serve import VortexServer  # noqa: E402
from repro_torch.models.model import prefill_step  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402


def flip_shares(topi_a, topi_b, b: int, s: int) -> list[float]:
    """Per layer: the share of the real rows' (token, choice) assignments
    whose expert is not among the other run's choices for that token."""
    out = []
    for ta, tb in zip(topi_a, topi_b):
        ta, tb = ta[:b, :s], tb[:b, :s]
        same = (ta[..., :, None] == tb[..., None, :]).any(-1)
        out.append(float((~same).float().mean()))
    return out


def run_variant(cfg, params, tokens: np.ndarray) -> dict:
    b, s = tokens.shape
    fast = VortexServer(cfg, max_cache=256, params=params)
    plain = VortexServer(cfg, max_cache=256, params=params, impl="torch")
    bp, sp = fast.batch_bucket(b), fast.seq_bucket(s)
    toks = np.zeros((bp, sp), np.int64)
    toks[:b, :s] = tokens
    toks = torch.from_numpy(toks).to(fast.device)
    kvb = fast.kv_bucket(max(sp, s + 1))
    got = {}
    for name, srv in (("cuda", fast), ("torch", plain)):
        with srv.engine.use():
            logits, _, stats = prefill_step(
                cfg, srv.params, toks, cache_len=kvb, last=s - 1,
            )
        got[name] = (logits[:b, :cfg.vocab].float(), stats["topi"])
    ref = got["torch"][0]
    err = (got["cuda"][0] - ref).abs().max().item()
    per_layer = flip_shares(got["cuda"][1], got["torch"][1], b, s)
    return {
        "logits_rel": err / max(ref.abs().max().item(), 1e-6),
        "flip_share": float(np.mean(per_layer)),
        "flip_share_per_layer": per_layer,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_routing_drift: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    cfg = get_config(args.arch)
    m = cfg.moe
    tokens = np.random.default_rng(args.seed).integers(0, cfg.vocab, (1, 57))
    t0 = time.perf_counter()
    params = VortexServer(cfg, max_cache=256, seed=args.seed).params
    print(f"{cfg.name}: seeded init {time.perf_counter() - t0:.1f}s")

    def ref_scale(tree, to_f32: bool):
        """A copy with the expert stacks at the JAX package's init scale
        (std E^-1/2), optionally cast to float32 (the router already is)."""
        out = {
            k: (v.float() if to_f32 else v) if torch.is_tensor(v)
            else ref_scale(v, to_f32)
            for k, v in tree.items()
        }
        moe = out.get("moe", {})
        for name, fan_in in (("w_in", cfg.d_model), ("w_gate", cfg.d_model),
                             ("w_out", m.d_ff_expert)):
            if name in moe:
                moe[name] = moe[name] * (fan_in / m.num_experts) ** 0.5
        return out

    results = {}
    for name, vcfg, vparams in (
        ("bf16", cfg, params),
        ("bf16-ref-scale", cfg, ref_scale(params, False)),
        ("f32-ref-scale", dataclasses.replace(cfg, dtype="float32"),
         ref_scale(params, True)),
    ):
        r = run_variant(vcfg, vparams, tokens)
        results[name] = r
        print(f"{name}: logits_rel={r['logits_rel']:.6g} "
              f"flip_share={r['flip_share']:.6g} per_layer="
              f"{[round(x, 4) for x in r['flip_share_per_layer']]}",
              flush=True)
        del vparams
        torch.cuda.empty_cache()
    print(json.dumps({"arch": cfg.name, "card": smi, "prompt": [1, 57],
                      "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
