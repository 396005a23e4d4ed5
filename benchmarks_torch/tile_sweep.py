"""Where the selected tile ranks among the analyzer's next tensor-core
tiles, measured on one NVIDIA GPU.

    PYTHONPATH=src python benchmarks_torch/tile_sweep.py [--extra 5]

For each of the shapes the main paths give the wgmma kernels (PERF.md's
kernel table, rows 1, 2a, 3a, 3b and 4), it takes the H100
selector's predicted runtime cost of every ``tensor_core`` tile of the
lattice at that extent, and times the selected tile and the ``--extra``
next-cheapest ones (bf16, device time per call from ``torch.profiler``,
summed GPU activity over 50 calls), each checked against the plain
version first:

* row 1 — ``vortex_gemm`` at M = 128, N = K = 768 (``vortex.ops.gemm``'s
  bucket in ``chip_smoke.py`` phase 3);
* rows 3a and 3b — ``vortex_grouped_gemm`` on granite-moe-1b-a400m's
  w_in (K = 1024, N = 512) for 8 sequences of 64 tokens (prefill,
  capacity 20 in a 64-row bucket) and of 1 token (decode), counts routed
  top-8 of 32 uniformly from a seed;
* row 4 — ``vortex_gemm`` on ResNet-50 conv2_x's im2col matrix at batch 8
  (M = 25,088, N = 64, K = 576; the GEMM only, im2col is not timed);
* row 2a — ``flash_attention`` prefill on paper-gpt2-124m's largest
  prefill (q (8, 12, 64, 64), causal, kv_len 64), the selected tile
  against the next ``tensor_core`` (block_q, block_k) tiles;
* row 2b — ``flash_attention`` decode on its last decode step (q (8, 12,
  1, 64) against a 128-row cache, kv_len 71) at every block_k of the
  lattice, which also sets the number of kv splits.

It only measures: no selection, lattice or cost changes.  The card's name
and power limit are printed first; the last line is one JSON object with
every number.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import vortex  # noqa: E402
from repro_torch.core.cost_model import runtime_costs  # noqa: E402
from repro_torch.core.workloads import (  # noqa: E402
    AttentionWorkload,
    DecodeAttentionWorkload,
    GemmWorkload,
    GroupedGemmWorkload,
)
from repro_torch.kernels.attention import (  # noqa: E402
    decode_splits,
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.gemm import vortex_gemm, vortex_gemm_plain  # noqa: E402
from repro_torch.kernels.grouped_gemm import (  # noqa: E402
    vortex_grouped_gemm,
    vortex_grouped_gemm_plain,
)
from repro_torch.models.layers import moe_capacity  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402

TOL = 2.0 ** -7  # bf16: one ulp of the output scale
ATTN_TOL = 2.0 ** -6  # bf16 attention: one ulp plus the softmax order


def device_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Summed GPU activity per call over ``iters`` calls (torch.profiler);
    raises when nothing ran on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    )
    if not total_us > 0:
        raise RuntimeError("torch.profiler recorded no device activity")
    return total_us / iters / 1e3


def ranked_tensor_core_tiles(kern, m: int) -> list[tuple[tuple, float]]:
    """Every tensor_core l1 tile of the kernel's lattice with the
    selector's predicted cost at extent m, cheapest first."""
    st = kern.selector._stacked  # the fused lattices the selector ranks
    costs = runtime_costs(
        kern._hw, kern.workload, st.l1_tiles, st.l1_costs, m,
        kern.selector._num_cores,
    )
    tc = st.backends.index("tensor_core")
    idx = [i for i in np.argsort(costs, kind="stable")
           if st.backend_idx[i] == tc]
    return [(tuple(int(v) for v in st.l1_tiles[i]), float(costs[i]))
            for i in idx]


def routed_counts(rng, seqs: int, s: int, E: int, k: int, C: int) -> list[int]:
    """Per-group rows of one MoE layer for ``seqs`` sequences of ``s``
    tokens, each choosing ``k`` distinct experts uniformly, capped at C;
    expert-major, group = e * seqs + sequence."""
    counts = [0] * (E * seqs)
    for seq in range(seqs):
        for _ in range(s):
            for e in rng.permutation(E)[:k]:
                counts[e * seqs + seq] += 1
    return [min(c, C) for c in counts]


def check(out, ref, where: str, tol: float = TOL) -> float:
    o, r = out.float(), ref.float()
    rel = float((o - r).abs().max() / r.abs().max().clamp_min(1e-6))
    if not (torch.isfinite(o).all() and rel <= tol):
        raise RuntimeError(f"{where}: rel {rel} above {tol}")
    return rel


def sweep(name: str, kern, m: int, extra: int, make_call, plain,
          tol: float = TOL) -> dict:
    sel = kern.select(m)
    ranked = ranked_tensor_core_tiles(kern, m)
    chosen = tuple(sel.strategy.l1)
    tiles = [chosen] + [t for t, _ in ranked if t != chosen][:extra]
    cost = dict(ranked)
    ref = plain()
    rows = []
    for tile in tiles:
        call = make_call(tile)
        rel = check(call(), ref, f"{name} {tile}", tol)
        rows.append({"tile": list(tile), "predicted_us": cost[tile] * 1e6,
                     "ms": device_ms(call), "rel_err": rel,
                     "selected": tile == chosen})
    by_time = sorted(rows, key=lambda r: r["ms"])
    rank = 1 + next(i for i, r in enumerate(by_time) if r["selected"])
    for r in rows:
        print(f"{name}: tile={tuple(r['tile'])} "
              f"{'selected ' if r['selected'] else ''}"
              f"predicted_us={r['predicted_us']:.3f} ms={r['ms']:.5f} "
              f"rel={r['rel_err']:.3g}")
    print(f"{name}: the selected tile {chosen} ranks {rank} of {len(rows)} "
          f"by measured time (backend {sel.strategy.backend})")
    return {"name": name, "m": m, "selected": list(chosen),
            "selected_rank": rank, "tiles": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extra", type=int, default=5,
                    help="tensor_core tiles timed beside the selected one")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    eng = vortex.Engine()  # the H100 lattice and selector, on the card
    out = []

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev, dt)

    for name, M, N, K in (("row 1 gemm", 128, 768, 768),
                          ("row 4 conv2_x gemm", 25088, 64, 576)):
        kern = eng.kernel_for(GemmWorkload(M=None, N=N, K=K))
        a, b = rnd(M, K), rnd(K, N) * K ** -0.5

        def gemm_call(tile, a=a, b=b, M=M):
            bm, bn, bk = tile
            return lambda: vortex_gemm(a, b, M, block_m=bm, block_n=bn,
                                       block_k=bk, backend="tensor_core")

        out.append(sweep(name, kern, M, args.extra, gemm_call,
                         lambda a=a, b=b: vortex_gemm_plain(a, b)))

    cfg = get_config("granite-moe-1b-a400m")
    E, k, fe, d = (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
                   cfg.d_model)
    seqs = 8
    G = E * seqs
    kern = eng.kernel_for(GroupedGemmWorkload(C=None, G=G, E=E, N=fe, K=d))
    w = rnd(E, d, fe) * d ** -0.5
    for name, s in (("row 3a grouped prefill", 64), ("row 3b grouped decode", 1)):
        C = moe_capacity(cfg, s)
        cp = kern.select(C).padded_m
        counts = routed_counts(rng, seqs, s, E, k, C)
        x = rnd(G, cp, d)
        for i, n in enumerate(counts):
            x[i, n:] = float("nan")  # the routing pad
        cnt = torch.tensor(counts, dtype=torch.int32, device=dev)

        def grouped_call(tile, x=x, cnt=cnt):
            bm, bn, bk = tile
            return lambda: vortex_grouped_gemm(
                x, w, cnt, block_m=bm, block_n=bn, block_k=bk,
                backend="tensor_core")

        out.append(sweep(name, kern, C, args.extra, grouped_call,
                         lambda x=x, cnt=cnt: vortex_grouped_gemm_plain(
                             x, w, cnt)))
    # Row 2a: prefill attention at the selected tile and the next ones.
    hd, H, bp, sp = 64, 12, 8, 64
    kern = eng.kernel_for(AttentionWorkload(seq=None, head_dim=hd))
    q, k, v = rnd(bp, H, sp, hd), rnd(bp, H, sp, hd), rnd(bp, H, sp, hd)

    def attn_call(tile):
        bq, _, bk = tile
        return lambda: flash_attention(q, k, v, sp, block_q=bq, block_k=bk,
                                       backend="tensor_core")

    out.append(sweep("row 2a attention prefill", kern, sp, args.extra,
                     attn_call, lambda: flash_attention_plain(q, k, v, sp),
                     ATTN_TOL))

    # Row 2b: decode attention at every block_k of the lattice.
    kvb, kv_len = 128, 71
    kern = eng.kernel_for(DecodeAttentionWorkload(seq=None, head_dim=hd))
    chosen = kern.select(kvb).strategy.l1[2]
    q = rnd(bp, H, 1, hd)
    k, v = rnd(bp, H, kvb, hd), rnd(bp, H, kvb, hd)
    k[:, :, kv_len:] = float("nan")  # the cache past kv_len
    v[:, :, kv_len:] = float("nan")
    ref = flash_attention_plain(q, k, v, kv_len, kv_len - 1, causal=False)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for bk in sorted({t[2] for t, _ in ranked_tensor_core_tiles(kern, kvb)}):
        def call(bk=bk):
            return flash_attention(q, k, v, kv_len, kv_len - 1, block_q=1,
                                   block_k=bk, backend="tensor_core",
                                   causal=False)

        rel = check(call(), ref, f"row 2b decode block_k={bk}", ATTN_TOL)
        splits = decode_splits(bp * H, kv_len, bk, sms)[1]
        rows.append({"block_k": bk, "splits": splits, "ms": device_ms(call),
                     "rel_err": rel, "selected": bk == chosen})
        print(f"row 2b attention decode: block_k={bk} splits={splits} "
              f"{'selected ' if bk == chosen else ''}"
              f"ms={rows[-1]['ms']:.5f} rel={rel:.3g}")
    out.append({"name": "row 2b attention decode", "m": kvb,
                "selected": chosen, "tiles": rows})
    print(json.dumps({"card": smi, "sweeps": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
