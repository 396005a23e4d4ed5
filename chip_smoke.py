"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit and no result line):

1. Build the hand-written kernels from src/repro_torch/csrc (nvcc, sm_90a)
   and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, in
   bfloat16 and float32: the GEMM with NaN-poisoned m_true tails and N/K
   tails that do not divide the block; attention causal and not, window,
   softcap, GQA, per-row kv_len including 0, and decode with q_offset.
3. Main path 1: ``vortex.ops.gemm`` at dynamic M in {1, bucket-1, bucket,
   bucket+1, a prime} — exactly one kernel launch per call, 0 padded calls.
4. Main path 2: ``VortexServer`` serving paper-gpt2-124m at full width
   (seeded torch init), 8 requests of batch 1-8 and prompt 4-64,
   max_new 8, max_cache 256 — one decode step per token, n_layers
   decode-attention launches per token, 0 padded calls, 0 stage copies at
   aligned kv buckets; one request's prefill and decode logits against
   the same server with impl="torch".
5. Time each kernel at the main path's shapes beside its plain version,
   its bound and one PyTorch library call computing the same function
   (device time per call from torch.profiler).
6. Print the kernels line, then the result line.

Tolerances (max |kernel - plain| over max |plain|, per case): float32
1e-5 (f32 accumulation order); bfloat16 2^-7 for the GEMM (one bf16 ulp of
the final cast) and 2^-6 for attention (one ulp plus the f32 softmax
order); server logits 5e-2 (bf16 activations through 12 layers, two
attention lowerings).
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
H100_HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
H100_PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, same
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
LOGIT_TOL = 5e-2
ARCH = "paper-gpt2-124m"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        return float("inf"), float("inf")
    err = (o - r).abs().max().item()
    return err, err / max(r.abs().max().item(), 1e-6)


def device_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Device time of one call of ``fn``: the summed GPU activity (kernels
    and copies) that torch.profiler records over ``iters`` calls, divided
    by ``iters``.  Host time between launches is excluded, so a small
    kernel is not timed by its Python wrapper.  No recorded device
    activity means nothing ran on the card, and fails the run."""
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
        fail("torch.profiler recorded no device activity for a timed call")
    return total_us / iters / 1e3


def timed(row: dict, **fns) -> dict:
    """Fill ``row`` with the device time of each named callable."""
    for key, fn in fns.items():
        row[key] = device_ms(fn)
    return row


def check(name: str, out: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """Max |out - ref|; fails the run when the error relative to
    max |ref| is above ``tol``."""
    err, rel = rel_err(out, ref)
    print(f"{name}: max_abs_err={err:.3g} rel={rel:.3g} (tolerance {tol:.3g})")
    if not rel <= tol:
        fail(f"{name} disagrees with its plain version: {rel}")
    return err


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_PEAK[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(dev, errs: dict) -> None:
    from repro_torch.kernels.attention import (
        flash_attention,
        flash_attention_plain,
    )
    from repro_torch.kernels.gemm import vortex_gemm, vortex_gemm_plain

    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    gemm_cases = [
        # (M, N, K, m_true, block_m, block_n, block_k)
        (100, 96, 80, 77, 64, 64, 32),
        (256, 768, 768, 200, 128, 128, 64),
        (33, 50, 70, 33, 16, 32, 16),
        (5, 3072, 768, 3, 64, 256, 128),
    ]
    attn_cases = {
        # (b, hq, hkv, sq, skv, d, bq, bk, causal, window, softcap, kv, off)
        "causal": (2, 12, 12, 100, 100, 64, 64, 32, True, None, None, 90, 0),
        "noncausal_kv0": (2, 4, 4, 70, 80, 16, 16, 16, False, None, None,
                          [80, 0], 0),
        "window_gqa": (2, 6, 2, 64, 64, 64, 64, 64, True, 8, None, 64, 0),
        "softcap": (1, 4, 4, 64, 64, 64, 128, 16, True, None, 5.0, 50, 0),
        "decode_offset": (3, 12, 12, 1, 256, 64, 1, 64, False, None, None,
                          [100, 0, 256], [99, -1, 255]),
    }
    for dtype in (torch.float32, torch.bfloat16):
        for M, N, K, mt, bm, bn, bk in gemm_cases:
            a, b = rnd(M, K, dtype=dtype), rnd(K, N, dtype=dtype)
            a[mt:] = float("nan")
            err = check(
                f"vortex_gemm {dtype} M={M} N={N} K={K} m_true={mt} "
                f"blocks=({bm},{bn},{bk})",
                vortex_gemm(a, b, mt, block_m=bm, block_n=bn, block_k=bk),
                vortex_gemm_plain(a, b, mt), TOL[dtype])
            errs["vortex_gemm"] = max(errs["vortex_gemm"], err)
        for name, c in attn_cases.items():
            b_, hq, hkv, sq, skv, d, bq, bk, causal, window, softcap, kv, off = c
            q = rnd(b_, hq, sq, d, dtype=dtype)
            k = rnd(b_, hkv, skv, d, dtype=dtype)
            v = rnd(b_, hkv, skv, d, dtype=dtype)
            if isinstance(kv, int):
                k[:, :, kv:] = float("nan")
                v[:, :, kv:] = float("nan")
                kv_a, off_a = kv, off
            else:
                kv_a = torch.tensor(kv, dtype=torch.int32)
                off_a = torch.tensor(off, dtype=torch.int32) \
                    if isinstance(off, list) else off
            out = flash_attention(
                q, k, v, kv_a, off_a, block_q=bq, block_k=bk, causal=causal,
                window=window, softcap=softcap,
            )
            ref = flash_attention_plain(
                q, k, v, kv_a, off_a, causal=causal, window=window,
                softcap=softcap,
            )
            err = check(f"flash_attention {name} {dtype}", out, ref,
                        ATTN_TOL[dtype])
            if not isinstance(kv, int):
                for i, n in enumerate(kv):
                    if n == 0 and not (out[i] == 0).all():
                        fail(f"flash_attention {name}: kv_len 0 row not zero")
            form = "decode" if sq == 1 else "prefill"
            key = f"flash_attention_{form}"
            errs[key] = max(errs[key], err)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Phase 3: main path 1 — vortex.ops.gemm
# ---------------------------------------------------------------------------


def phase_gemm(dev, kernels) -> dict:
    from repro_torch import vortex
    from repro_torch.kernels.gemm import vortex_gemm_plain

    eng = vortex.Engine()  # the defaults: H100 lattice, CUDA kernels, card
    d = 768
    g = torch.Generator().manual_seed(1)
    b = torch.randn(d, d, generator=g).to(dev, torch.bfloat16)
    op = vortex.compile("gemm", engine=eng, M=None, N=d, K=d)
    bucket = op.bucket(100)
    ms = [1, bucket - 1, bucket, bucket + 1, 97]
    inputs = [torch.randn(m, d, generator=g).to(dev, torch.bfloat16) for m in ms]
    kernels.reset_launch_counts()
    before = op.stats()["dispatch"]
    outs = []
    with vortex.use(eng):
        for a in inputs:
            n0 = kernels.launch_counts()["vortex_gemm"]
            outs.append(vortex.ops.gemm(a, b))
            if kernels.launch_counts()["vortex_gemm"] - n0 != 1:
                fail("vortex.ops.gemm did not make exactly one kernel launch")
    launches = kernels.launch_counts()["vortex_gemm"]
    torch.cuda.synchronize()
    after = op.stats()["dispatch"]
    padded = after["padded_calls"] - before["padded_calls"]
    print(f"main path gemm: M={ms} bucket={bucket} kernel_launches={launches} "
          f"engine_launches={after['launches'] - before['launches']} "
          f"padded_calls={padded} "
          f"stage_copies={after['stage_copies'] - before['stage_copies']}")
    if launches != len(ms) or padded != 0:
        fail("gemm main path: expected one launch per call and 0 padded calls")
    worst = 0.0
    for a, out in zip(inputs, outs):
        if out.shape != (a.shape[0], d):
            fail(f"gemm main path: output shape {tuple(out.shape)}")
        _, rel = rel_err(out, vortex_gemm_plain(a, b))
        worst = max(worst, rel)
    if not worst <= TOL[torch.bfloat16]:
        fail(f"gemm main path disagrees with the plain version: {worst}")
    sel = op.select(bucket)
    return {"launches": launches, "M": bucket, "N": d, "K": d,
            "blocks": sel.strategy.l1}


# ---------------------------------------------------------------------------
# Phase 4: main path 2 — VortexServer on paper-gpt2-124m
# ---------------------------------------------------------------------------


def phase_serve(dev, kernels) -> dict:
    from repro_torch.launch.serve import Request, VortexServer
    from repro_torch.models.model import decode_step, prefill_step
    from repro_torch.models.registry import get_config

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    server = VortexServer(cfg, max_cache=256, seed=0)
    print(f"server: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}x{cfg.resolved_head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} dtype={cfg.dtype} "
          f"hardware={server.engine.config.hardware} "
          f"impl={server.engine.config.impl} init_s={time.perf_counter() - t0:.2f}")
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(8):
        b = int(rng.integers(1, 9)) if i else 8
        s = int(rng.integers(4, 65)) if i else 64
        toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)
        reqs.append(Request(tokens=toks, max_new=8))
    server.warmup(max_batch=8, m_max=64, max_new=8)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [server.generate(r) for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()

    tokens = sum(o.size for o in outs)
    steps = sum(r.max_new - 1 for r in reqs)
    st = server.engine_dispatch_stats()
    ds = st["decode_step"]
    print(f"main path serve: requests={len(reqs)} "
          f"shapes={[r.tokens.shape for r in reqs]} tokens={tokens} "
          f"decode_steps={ds['launches']} wall_s={wall:.3f} "
          f"kernel_launches={counts}")
    print(f"engine: attention={st['attention']} "
          f"decode_attention={st['decode_attention']} kv_pool={st['kv_pool']}")
    for r, o in zip(reqs, outs):
        if o.shape != (r.tokens.shape[0], r.max_new):
            fail(f"serve: output shape {o.shape}")
        if not ((o >= 0) & (o < cfg.vocab)).all():
            fail("serve: token outside the vocabulary")
    if ds["launches"] != steps or ds["padded_calls"] != 0:
        fail(f"serve: {ds['launches']} decode steps for {steps} tokens")
    if counts["flash_attention_decode"] != cfg.n_layers * steps:
        fail("serve: expected n_layers decode-attention launches per token")
    if counts["flash_attention_prefill"] != cfg.n_layers * len(reqs):
        fail("serve: expected n_layers prefill-attention launches per request")
    dec = st["decode_attention"]
    if dec["padded_calls"] or dec["stage_copies"] or st["attention"]["padded_calls"]:
        fail(f"serve: padded calls or stage copies on the decode path: {dec}")
    if st["kv_pool"]["leases_active"] != 0:
        fail("serve: kv pool leases leaked")

    # One request against the same server lowered with impl="torch".
    plain = VortexServer(cfg, max_cache=256, params=server.params, impl="torch")
    r = reqs[1]
    b, s = r.tokens.shape
    bp, sp = server.batch_bucket(b), server.seq_bucket(s)
    toks = np.zeros((bp, sp), np.int64)
    toks[:b, :s] = r.tokens
    toks = torch.from_numpy(toks).to(dev)
    kvb = server.kv_bucket(max(sp, s + 1))  # room for the decode row at s
    worst = {}
    logits = {}
    for name, srv in (("cuda", server), ("torch", plain)):
        with srv.engine.use():
            lp, cache = prefill_step(cfg, srv.params, toks, cache_len=kvb,
                                     last=s - 1)
            nxt = lp.argmax(-1)[:, None] if name == "cuda" else logits["next"]
            logits.setdefault("next", nxt)
            ld, _ = decode_step(cfg, srv.params, cache, nxt, s)
        logits[name] = (lp[:b], ld[:b])
    for i, phase in enumerate(("prefill", "decode")):
        # The vocab pad columns hold -1e30 on both sides; compare the rest.
        err, rel = rel_err(logits["cuda"][i][:, :cfg.vocab],
                           logits["torch"][i][:, :cfg.vocab])
        worst[phase] = rel
        print(f"serve {phase} logits vs impl=torch: max_abs_err={err:.4g} "
              f"rel={rel:.4g} (tolerance {LOGIT_TOL})")
        if not rel <= LOGIT_TOL:
            fail(f"serve {phase} logits disagree with impl='torch': {rel}")
    torch.cuda.synchronize()

    # The shapes the main path gave the attention kernels: the largest
    # request's prefill, and its last decode step (kv_len = pos + 1 rows of
    # the kv bucket the cache had grown to by then).
    big = max(reqs, key=lambda q: q.tokens.size)
    bp = server.batch_bucket(big.tokens.shape[0])
    sp = server.seq_bucket(big.tokens.shape[1])
    kv_len = big.tokens.shape[1] + big.max_new - 1
    kvb = server.kv_bucket(sp)
    if kv_len > kvb:
        kvb = server._grown_kv_bucket(kvb, kv_len)
    return {
        "counts": counts, "cfg": cfg, "server": server, "bp": bp, "sp": sp,
        "kvb": kvb, "kv_len": kv_len, "logit_rel": worst,
        "tokens": tokens, "wall_s": wall,
    }


# ---------------------------------------------------------------------------
# Phase 5: timings at the main path's shapes
# ---------------------------------------------------------------------------


def phase_time(dev, gemm_info, serve_info, errs) -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.core.workloads import (
        AttentionWorkload,
        DecodeAttentionWorkload,
    )
    from repro_torch.kernels.attention import (
        flash_attention,
        flash_attention_plain,
    )
    from repro_torch.kernels.gemm import vortex_gemm, vortex_gemm_plain

    dt = torch.bfloat16
    g = torch.Generator().manual_seed(2)
    rows = []

    M, N, K = gemm_info["M"], gemm_info["N"], gemm_info["K"]
    bm, bn, bk = gemm_info["blocks"]
    a = torch.randn(M, K, generator=g).to(dev, dt)
    b = torch.randn(K, N, generator=g).to(dev, dt)
    err = check("vortex_gemm at the main path's shape",
                vortex_gemm(a, b, M, block_m=bm, block_n=bn, block_k=bk),
                vortex_gemm_plain(a, b, M), TOL[dt])
    errs["vortex_gemm"] = max(errs["vortex_gemm"], err)
    bnd, by = bound_ms(2 * (M * K + K * N + M * N), 2 * M * N * K, dt)
    rows.append(timed(
        {
            "name": "vortex_gemm", "route": "cuda",
            "source": "src/repro_torch/csrc/gemm.cu",
            "replaces": "src/repro/kernels/gemm.py:110",
            "launches": gemm_info["launches"],
            "max_abs_err": errs["vortex_gemm"],
            "bound_ms": bnd, "bound_by": by,
            "shape": f"M={M} N={N} K={K} blocks=({bm},{bn},{bk}) bf16",
        },
        ms=lambda: vortex_gemm(a, b, M, block_m=bm, block_n=bn, block_k=bk),
        plain_ms=lambda: vortex_gemm_plain(a, b, M),
        library_ms=lambda: torch.matmul(a, b),
    ))

    cfg, server = serve_info["cfg"], serve_info["server"]
    eng = server.engine
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    bp, sp, kvb, kv_len = (serve_info[k] for k in ("bp", "sp", "kvb", "kv_len"))
    counts = serve_info["counts"]

    # Prefill: the engine calls the kernel at the bucket shape with
    # kv_len = sp, causal (the whole padded prompt is valid keys).
    sel = eng.kernel_for(AttentionWorkload(seq=None, head_dim=hd)).select(sp)
    m1, _, k1 = sel.strategy.l1
    q, k, v = (torch.randn(bp, H, sp, hd, generator=g).to(dev, dt)
               for _ in range(3))
    err = check("flash_attention prefill at the main path's shape",
                flash_attention(q, k, v, sp, block_q=m1, block_k=k1),
                flash_attention_plain(q, k, v, sp), ATTN_TOL[dt])
    errs["flash_attention_prefill"] = max(errs["flash_attention_prefill"], err)
    flops = 4.0 * hd * bp * H * sp * (sp + 1) / 2  # causal keys per row
    bnd, by = bound_ms(4 * bp * H * sp * hd * 2, flops, dt)
    rows.append(timed(
        {
            "name": "flash_attention (prefill)", "route": "cuda",
            "source": "src/repro_torch/csrc/attention.cu",
            "replaces": "src/repro/kernels/attention.py:125",
            "launches": counts["flash_attention_prefill"],
            "max_abs_err": errs["flash_attention_prefill"],
            "bound_ms": bnd, "bound_by": by,
            "shape": f"q=({bp},{H},{sp},{hd}) kv_len={sp} "
                     f"blocks=({m1},{k1}) causal bf16",
        },
        ms=lambda: flash_attention(q, k, v, sp, block_q=m1, block_k=k1),
        plain_ms=lambda: flash_attention_plain(q, k, v, sp),
        library_ms=lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True),
    ))

    # Decode: one query row against the kv-bucket cache, kv_len valid rows.
    sel = eng.kernel_for(DecodeAttentionWorkload(seq=None, head_dim=hd)) \
        .select(kvb)
    k1 = sel.strategy.l1[2]
    q = torch.randn(bp, H, 1, hd, generator=g).to(dev, dt)
    k, v = (torch.randn(bp, H, kvb, hd, generator=g).to(dev, dt)
            for _ in range(2))
    mask = (torch.arange(kvb, device=dev) < kv_len)[None, :]

    def dec():
        return flash_attention(q, k, v, kv_len, kv_len - 1, block_q=1,
                               block_k=k1, causal=False)

    def dec_plain():
        return flash_attention_plain(q, k, v, kv_len, kv_len - 1,
                                     causal=False)

    err = check("flash_attention decode at the main path's shape",
                dec(), dec_plain(), ATTN_TOL[dt])
    errs["flash_attention_decode"] = max(errs["flash_attention_decode"], err)
    nbytes = 2 * (2 * bp * H * hd + 2 * bp * H * kv_len * hd)
    bnd, by = bound_ms(nbytes, 4.0 * hd * bp * H * kv_len, dt)
    rows.append(timed(
        {
            "name": "flash_attention (decode)", "route": "cuda",
            "source": "src/repro_torch/csrc/attention.cu",
            "replaces": "src/repro/kernels/attention.py:125",
            "launches": counts["flash_attention_decode"],
            "max_abs_err": errs["flash_attention_decode"],
            "bound_ms": bnd, "bound_by": by,
            "shape": f"q=({bp},{H},1,{hd}) cache={kvb} kv_len={kv_len} "
                     f"block_k={k1} bf16",
        },
        ms=dec,
        plain_ms=dec_plain,
        library_ms=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask),
    ))
    torch.cuda.synchronize()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda is not available: this script runs on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import kernels
        from repro_torch.kernels.build import library
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script: {e}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    library()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f}s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    errs = {"vortex_gemm": 0.0, "flash_attention_prefill": 0.0,
            "flash_attention_decode": 0.0}
    phase_kernels(dev, errs)
    print("phase 2: kernels agree with their plain versions")
    gemm_info = phase_gemm(dev, kernels)
    print("phase 3: vortex.ops.gemm main path ok")
    serve_info = phase_serve(dev, kernels)
    print("phase 4: VortexServer main path ok")
    rows = phase_time(dev, gemm_info, serve_info, errs)
    for r in rows:
        print(f"{r['name']}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']:.4f} launches={r['launches']} "
              f"[{r['shape']}; torch.profiler device time] on {smi}")
    print(smi)
    print(json.dumps({"kernels": rows, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
