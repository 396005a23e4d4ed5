"""Workload-generic engine benchmark of the port: dispatch overhead, the
padding-free hot path and the serving snapshot (counterpart of
benchmarks/bench_workloads.py).

It drives GEMM, flash attention and Conv2D through ONE vortex Engine
session and reports, per workload kind:

  * mean per-call select overhead for UNSEEN shapes on the
    offline-materialized selection table vs the fused argmin path (host
    only),
  * table/LRU/argmin serve counts over a repeated dynamic stream,
  * executable-cache entries vs calls served,
  * the padding-free hot path: steady-state wall-clock of UNALIGNED
    dispatch (staged masked-tail launch) vs ALIGNED dispatch (zero-copy
    launch) on the SAME bucket executable, plus copies/launches per call
    from the engine's DispatchStats and the kernels' own launch counters.

:func:`serving_payload` adds the serving sections (``decode``,
``continuous_batching``, ``prefill_chain``, ``moe``) and is what
``benchmarks_torch/run.py --json`` writes to ``BENCH_serving_torch.json``;
``--json`` here writes ``BENCH_dispatch_torch.json``.  Everything runs on
the card unless the caller passes ``device="cpu"`` (the tests do, with
``smoke=True``); on the card operands are bf16 and the executables are the
hand-written kernels.
Both JSON files carry the ``calibration`` section (:func:`_bench_calibration`).

    python benchmarks_torch/bench_workloads.py --json BENCH_dispatch_torch.json

What the serving counters mean in the port: on the card a decode step is
one replay of the CUDA graph captured for its (form, batch bucket, kv
bucket, cache), the counterpart of one launch of the reference's AOT
decode program, so ``launches_per_token`` and
``launches_per_batched_step`` count graph replays (one per token, one per
batched step); with graphs off (the CPU) they count eager steps.  The
hand-written kernels' own launches per token and per step stand beside
them (``kernel_launches_per_token``, ``kernel_launches_per_batched_step``:
n_layers ``decode_attention`` launches a step, inside the graph), and
``decode_graph_captures`` / ``decode_graph_replays`` count what happened
inside the timed windows (``timed_steps`` decode steps): 0 captures and
one replay a step with graphs on.  The prefills inside those windows are
``"aot"`` prefills, one replay of a captured prefill graph each on the
card (``prefill_graph_captures`` / ``prefill_graph_replays``).
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

from benchmarks_torch.util import card_line, dtype_for, emit, randn  # noqa: E402
from repro_torch.core.hardware import get_hardware  # noqa: E402
from repro_torch.core.selector import RuntimeSelector  # noqa: E402
from repro_torch.core.timing import (  # noqa: E402
    interleaved_minima,
    retry_best,
    synchronize,
)
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.vortex import Engine  # noqa: E402

# Dynamic streams: every shape appears twice (second pass measures cache
# behaviour), sizes deliberately prime/non-tile-aligned.
GEMM_MS = [5, 33, 63, 128, 200, 381]
ATTN_SEQS = [31, 67, 127, 199, 257]
CONV_BATCHES = [1, 2, 3, 5]

# Unseen-shape dispatch stream: distinct extents a serving process has
# never selected before.
DISPATCH_STREAM = 400
DISPATCH_M_MAX = 2048

# The hot path's static widths: the reference's (GEMM 2304, conv 1536,
# attention head 64, 8 q / 4 kv heads), so kernel compute dominates the
# boundary copies.  ``smoke`` cuts the GEMM/conv widths so the CPU tests
# stay short; the counters the gates read do not depend on them.
HOT_WIDTHS = {False: (2304, 1536), True: (256, 192)}

# bf16 GEMMs (grouped ones included) agree with their plain versions to one
# bf16 ulp of the final cast (chip_smoke.py's TOL), float32 to 1e-5.
MOE_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}

# The hot path's retry stops at the first attempt under this ratio, the
# reference's margin below its gate of 1.10 (run.py --gate checks it).
HOT_PATH_ACCEPT = 1.08


def _kernel_totals() -> dict[str, int]:
    """The executable kernels' launch totals (the per-path counters and
    the engine's staging copy left out)."""
    return {k: v for k, v in launch_counts().items()
            if "." not in k and k != "stage_copy"}


def _delta(before: dict, after: dict) -> dict[str, int]:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _bench(calls) -> float:
    t0 = time.perf_counter()
    for fn in calls:
        synchronize(fn())
    return (time.perf_counter() - t0) / len(calls)


def _bench_dispatch(eng, hw, smoke: bool) -> dict[str, dict]:
    """Per kind: mean select overhead for unseen extents, table vs argmin.

    Fresh selectors over the SAME scored lattices the engine serves from,
    so both paths price the identical strategy space; every extent in the
    stream is unseen by construction (new selector, distinct extents).
    """
    stream_len = 60 if smoke else DISPATCH_STREAM
    rng = np.random.default_rng(42)
    ms = rng.permutation(np.arange(1, DISPATCH_M_MAX + 1))[:stream_len]
    ms = [int(m) for m in ms]

    results: dict[str, dict] = {}
    seen_kinds: set[str] = set()
    for kernel in eng._kernels.values():
        wl = kernel.workload
        if wl.kind in seen_kinds:
            continue
        seen_kinds.add(wl.kind)
        scored = kernel.selector.scored
        tabled = RuntimeSelector(hw, wl, scored, table_m_max=DISPATCH_M_MAX)
        argmin = RuntimeSelector(hw, wl, scored, table_m_max=0, cache_size=1)
        assert tabled.table is not None  # materialize offline, not in-loop

        # Best-of-N passes: the table loop's whole window is tens of us, so
        # one scheduler preemption inside a pass would dominate the ratio.
        repeats = 5

        def _best_of(select) -> float:
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                for m in ms:
                    select(m)
                best = min(best, time.perf_counter() - t0)
            return best / len(ms) * 1e6

        table_us = _best_of(tabled.select)
        argmin_us = _best_of(argmin.select)

        assert tabled.stats.table_hits == len(ms) * repeats
        results[wl.kind] = {
            "table_us": table_us,
            "argmin_us": argmin_us,
            "speedup": argmin_us / max(table_us, 1e-9),
            "table_entries": len(tabled.table),
            "table_build_s": tabled.stats.table_build_seconds,
            "stream_len": len(ms),
        }
    return results


def _attn_aligned_seq(kern, s0: int) -> int:
    """The first extent >= s0 whose attention bucket pads NEITHER seq dim
    (pq == s == pkv): the zero-copy aligned case.  Walk bucket starts, not
    every integer."""
    s = s0
    for _ in range(64):
        sel = kern.select(s)
        if sel.bucket[0] == s and sel.bucket[2] == s:
            return s
        s = max(sel.bucket[0], sel.bucket[2])
    raise RuntimeError("no both-dims-aligned attention extent found")


def _same_entry_unaligned(kern, aligned_m: int) -> int:
    """The largest extent below ``aligned_m`` that the selector serves with
    the SAME strategy and bucket (hence the same executable): the
    aligned/unaligned comparison must time one program two ways."""
    ref = kern.select(aligned_m)
    for m in range(aligned_m - 1, max(aligned_m - 64, 0), -1):
        sel = kern.select(m)
        if (
            sel.bucket == ref.bucket
            and sel.strategy.l1 == ref.strategy.l1
            and sel.backend == ref.backend
        ):
            return m
    raise RuntimeError(
        f"no same-executable unaligned extent below {aligned_m}"
    )


def _bench_hot_path(smoke: bool, *, device="cuda",
                    hardware: str = "h100_sxm") -> dict[str, dict]:
    """Aligned vs unaligned steady-state dispatch on the SAME bucket.

    Per kind: the unaligned extent is below the bucket, the aligned extent
    the bucket itself (zero-copy launch) — the same executable, so the
    ratio isolates the cost the padding-free path adds at the boundary.
    On the card the unaligned call launches on its own operands (no
    staging copy, no output slice: ``folded_per_unaligned_call``); on the
    CPU it stages, launches masked and slices the output back
    (``copies_per_unaligned_call``).  The two sum to the reference's
    boundary copies per unaligned call.  Conv uses a
    1x1-kernel im2col view so the probe extents are exactly reachable.
    Each window is host wall-clock around synchronized calls: host staging
    plus device time.
    """
    eng = Engine(hardware, device=device, empirical_levels=())
    rng = np.random.default_rng(3)
    dtype = dtype_for(device)
    min_rounds = 20 if smoke else 30
    max_rounds = 80 if smoke else 120
    gw, cw = HOT_WIDTHS[smoke]

    def paired_us(aligned_call, unaligned_call):
        t = interleaved_minima(
            [aligned_call, unaligned_call],
            inner=2, min_rounds=min_rounds, max_rounds=max_rounds,
            patience=10,
        )
        return (
            t.best_s[0] * 1e6,
            t.best_s[1] * 1e6,
            t.ratio(1, 0),
            {
                "aligned_us": list(t.samples_us[0]),
                "unaligned_us": list(t.samples_us[1]),
            },
        )

    def arr(shape):
        return randn(rng, shape, device)

    cases: dict[str, tuple] = {}
    # gemm: any extent is reachable.
    gk = eng.op_kernel("gemm", (arr((8, gw)), arr((gw, gw))), {})
    gb = gk.select(381).padded_m
    gu = _same_entry_unaligned(gk, gb)
    wg = arr((gw, gw))
    ga, gua = arr((gb, gw)), arr((gu, gw))
    cases["gemm"] = (
        lambda: eng.dispatch("gemm", ga, wg),
        lambda: eng.dispatch("gemm", gua, wg),
    )
    # attention: aligned needs BOTH seq dims on their tile.
    q0 = (arr((2, 8, 8, 64)), arr((2, 4, 8, 64)), arr((2, 4, 8, 64)))
    ak = eng.op_kernel("attention", q0, {})
    sa = _attn_aligned_seq(ak, 199)
    su = _same_entry_unaligned(ak, sa)

    def attn_args(s):
        return (arr((2, 8, s, 64)), arr((2, 4, s, 64)), arr((2, 4, s, 64)))

    aa, au = attn_args(sa), attn_args(su)
    cases["attention"] = (
        lambda: eng.dispatch("attention", *aa),
        lambda: eng.dispatch("attention", *au),
    )
    # conv2d: 1x1 kernel -> im2col extent == the seq-like dim exactly.
    ck = eng.op_kernel("conv2d", (arr((1, 1, 8, cw)), arr((1, 1, cw, cw))), {})
    cb = ck.select(500).padded_m
    cu = _same_entry_unaligned(ck, cb)
    wc = arr((1, 1, cw, cw))
    xa, xu = arr((1, 1, cb, cw)), arr((1, 1, cu, cw))
    cases["conv2d"] = (
        lambda: eng.dispatch("conv2d", xa, wc),
        lambda: eng.dispatch("conv2d", xu, wc),
    )
    extents = {"gemm": (gb, gu), "attention": (sa, su), "conv2d": (cb, cu)}

    results: dict[str, dict] = {}
    for kind, (aligned_call, unaligned_call) in cases.items():
        before = dict(eng.stats()[kind])
        k_before = _kernel_totals()
        s_before = launch_counts()["stage_copy"]
        # Up to 4 measurement attempts, keeping the best ratio: throttling
        # noise is one-sided, so the min across attempts estimates the
        # true boundary cost while a real regression fails every attempt.
        gate: dict = {}
        aligned_us, unaligned_us, ratio, samples = retry_best(
            lambda: paired_us(aligned_call, unaligned_call),
            attempts=4,
            accept=lambda r: r[2] <= HOT_PATH_ACCEPT,
            key=lambda r: r[2],
            stats=gate,
        )
        after = eng.stats()[kind]
        k_launched = _delta(k_before, _kernel_totals())
        staged = launch_counts()["stage_copy"] - s_before
        calls = after["calls"] - before["calls"]
        unaligned = after["unaligned_calls"] - before["unaligned_calls"]
        results[kind] = {
            "aligned_extent": extents[kind][0],
            "unaligned_extent": extents[kind][1],
            "dtype": str(dtype).replace("torch.", ""),
            "aligned_us": aligned_us,
            "unaligned_us": unaligned_us,
            "unaligned_over_aligned": ratio,
            "samples": samples,
            "gate_attempts": gate.get("attempts", 1),
            "gate_accepted": gate.get("accepted", True),
            "min_round": {
                side: int(np.argmin(vals)) for side, vals in samples.items()
            },
            # The port has no degradation ladder: both stay 0.
            "fallbacks": after["fallbacks"] - before["fallbacks"],
            "quarantined": after["quarantined"] - before["quarantined"],
            "launches_per_call": (
                (after["launches"] - before["launches"]) / max(calls, 1)
            ),
            # The hand-written kernels' own launches per engine call (0 on
            # the CPU, where the executables are the plain versions).
            "kernel_launches_per_call": (
                sum(k_launched.values()) / max(calls, 1)
            ),
            "kernel_launches": k_launched,
            # The staging kernel's launches per unaligned call: 0 on the
            # card (the launch reads the operands where they are) and on
            # the CPU (plain copies).
            "stage_launches_per_unaligned_call": staged / max(unaligned, 1),
            # Boundary copies made per unaligned call (the CPU's staging)
            # and boundaries crossed with none (the card's launch on the
            # operands at their own extents).
            "copies_per_unaligned_call": (
                (
                    after["stage_copies"] + after["unstage_copies"]
                    - before["stage_copies"] - before["unstage_copies"]
                ) / max(unaligned, 1)
            ),
            "folded_per_unaligned_call": (
                (
                    after["folded_stages"] + after["folded_unstages"]
                    - before["folded_stages"] - before["folded_unstages"]
                ) / max(unaligned, 1)
            ),
            "padded_calls": after["padded_calls"] - before["padded_calls"],
        }
    return results


def _server(arch: str, smoke: bool, *, device, hardware: str):
    from repro_torch.launch.serve import VortexServer
    from repro_torch.models.registry import get_config, get_smoke_config

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    return VortexServer(cfg, max_cache=256, device=device, hardware=hardware)


def _bench_decode(smoke: bool, *, device="cuda",
                  hardware: str = "h100_sxm") -> dict:
    """The serving decode section: drive VortexServer through prompts whose
    generation crosses a kv-bucket boundary and report the per-token decode
    contract (one decode step per token, zero pad fallbacks, growth copies
    only at bucket transitions), the kernels' launches per token, and the
    steady-state wall-clock per token.  ``smoke`` serves the smoke config
    of paper-gpt2-124m, else its full config (12 layers, d_model 768)."""
    from repro_torch.launch.serve import Request

    server = _server("paper-gpt2-124m", smoke, device=device,
                     hardware=hardware)
    cfg = server.cfg
    rng = np.random.default_rng(17)
    s = 120
    kvb0 = server.kv_bucket(server.seq_bucket(s))
    max_new = min(max(kvb0 - s + 4, 8), 24)
    reqs = [
        Request(
            tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            max_new=max_new,
        )
        for b in (1, 2)
    ]
    # Warm every (batch, seq) shape once (and the kernel library, and the
    # decode graphs): the timed window below holds served requests only.
    for req in reqs:
        server.generate(req)
    tokens_before = server.decode_stats.calls
    g_before = _graph_counts(server)
    k_before = _kernel_totals()
    t0 = time.perf_counter()
    for req in reqs:
        server.generate(req)
    wall = time.perf_counter() - t0
    k_launched = _delta(k_before, _kernel_totals())
    g_timed = _delta(g_before, _graph_counts(server))
    d = server.decode_stats
    tokens = d.calls
    timed = max(tokens - tokens_before, 1)
    eng_decode = server.engine_dispatch_stats()["decode_attention"]
    return {
        "arch": cfg.name,
        "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "tokens": tokens,
        "counter_meaning": (
            "launches_per_token counts decode steps per token, each one "
            "replay of a captured CUDA graph (one eager step with graphs "
            "off), as the reference counts launches of one AOT decode "
            "program; kernel_launches_per_token counts the hand-written "
            "kernels' launches per token, inside the graph"
        ),
        "graphs": server.graphs is not None,
        "timed_steps": timed,
        **{k: g_timed.get(k, 0) for k in GRAPH_COUNTERS},
        "launches_per_token": d.launches / max(tokens, 1),
        "kernel_launches_per_token": {
            k: n / timed for k, n in k_launched.items()
            if k == "flash_attention_decode"
        },
        "padded_calls": d.padded_calls,
        "growth_copies": d.stage_copies,
        "bucket_transitions": d.unaligned_calls,
        "decode_exec_buckets": len(server._decode_seen),
        "decode_buckets": server.stats["decode_buckets"],
        "engine_launches_per_token": eng_decode["launches"] / max(tokens, 1),
        "engine_padded_calls": eng_decode["padded_calls"],
        "decode_us_per_token": wall / timed * 1e6,
    }


GRAPH_COUNTERS = ("decode_graph_captures", "decode_graph_replays",
                  "prefill_graph_captures", "prefill_graph_replays")


def _graph_counts(server) -> dict[str, int]:
    return {k: server.stats[k] for k in GRAPH_COUNTERS}


def _bench_continuous_batching(smoke: bool, *, device="cuda",
                               hardware: str = "h100_sxm") -> dict:
    """The continuous-batching section: the SAME 16 requests served (a)
    serially through ``generate()`` and (b) through ContinuousScheduler at
    concurrency 1/4/16, reporting tokens/s per mode plus the batched-step
    contract: exactly one decode step per batched step (rows at different
    kv positions share it), zero padded calls, and the kernels' launches
    per batched step."""
    from repro_torch.launch.scheduler import ContinuousScheduler
    from repro_torch.launch.serve import Request

    server = _server("paper-gpt2-124m", smoke, device=device,
                     hardware=hardware)
    cfg = server.cfg
    rng = np.random.default_rng(23)
    max_new = 8
    reqs = [
        Request(
            tokens=rng.integers(0, cfg.vocab, (1, int(s))).astype(np.int32),
            max_new=max_new,
        )
        for s in rng.integers(30, 60, 16)
    ]
    total_tokens = len(reqs) * max_new

    def timed_serial() -> tuple[float, dict]:
        g_before = _graph_counts(server)
        t0 = time.perf_counter()
        for req in reqs:
            server.generate(req)
        wall = time.perf_counter() - t0
        return wall, _delta(g_before, _graph_counts(server))

    def timed_sched(batch_rows: int) -> tuple[float, dict, dict, dict]:
        sched = ContinuousScheduler(server, batch_rows=batch_rows)
        k_before = _kernel_totals()
        g_before = _graph_counts(server)
        t0 = time.perf_counter()
        for req in reqs:
            sched.submit(req)
        res = sched.drain()
        wall = time.perf_counter() - t0
        k_launched = _delta(k_before, _kernel_totals())
        g_timed = _delta(g_before, _graph_counts(server))
        assert len(res) == len(reqs)
        sched.close()
        return wall, sched.stats, k_launched, g_timed

    timed_serial()  # warm every prefill/decode bucket (and graph)
    serial_wall, g_serial = timed_serial()
    serial_steps = sum(r.max_new - 1 for r in reqs)
    out: dict = {
        "arch": cfg.name,
        "n_layers": cfg.n_layers,
        "requests": len(reqs),
        "max_new": max_new,
        "counter_meaning": (
            "launches_per_batched_step counts decode steps per batched "
            "step, each one replay of a captured CUDA graph (one eager "
            "step with graphs off), as the reference counts launches of "
            "one AOT decode program; kernel_launches_per_batched_step "
            "counts the hand-written decode-attention launches per step, "
            "inside the graph"
        ),
        "graphs": server.graphs is not None,
        "serial_tokens_per_s": total_tokens / serial_wall,
        "concurrency": {},
    }
    timed_steps = serial_steps
    graphs = {k: g_serial.get(k, 0) for k in GRAPH_COUNTERS}
    worst_lps, padded = 0.0, 0
    for c in (1, 4, 16):
        timed_sched(c)  # warm the (c, kvb) mixed-progress shapes and graphs
        wall, stats, k_launched, g_timed = timed_sched(c)
        timed_steps += stats["steps"]
        for k in GRAPH_COUNTERS:
            graphs[k] += g_timed.get(k, 0)
        steps = max(stats["steps"], 1)
        lps = stats["launches"] / steps
        worst_lps = max(worst_lps, lps)
        padded += stats["padded_calls"]
        out["concurrency"][str(c)] = {
            "tokens_per_s": total_tokens / wall,
            "batched_steps": stats["steps"],
            "launches_per_batched_step": lps,
            "kernel_launches_per_batched_step": (
                k_launched.get("flash_attention_decode", 0) / steps
            ),
            "kernel_launches": k_launched,
            "padded_calls": stats["padded_calls"],
            "decode_graph_captures": g_timed.get("decode_graph_captures", 0),
            "decode_graph_replays": g_timed.get("decode_graph_replays", 0),
        }
    # Every timed window: the serial pass and each concurrency's.
    out["timed_steps"] = timed_steps
    out.update(graphs)
    out["launches_per_batched_step"] = worst_lps
    out["padded_calls"] = padded
    out["speedup_at_16"] = (
        out["concurrency"]["16"]["tokens_per_s"]
        / out["serial_tokens_per_s"]
    )
    pool = server.engine_dispatch_stats()["kv_pool"]
    out["kv_pool"] = pool
    assert pool["leases_active"] == 0, pool
    return out


def _bench_prefill_chain(smoke: bool, *, device="cuda",
                         hardware: str = "h100_sxm") -> dict:
    """The chained-prefill section (DESIGN.md §8): whole-model prefills
    through launch/serve.py's lazy handle chain, reporting the
    boundary-copy contract -- zero interior unstage+restage pairs at a
    chain-aligned bucket, every engine boundary forwarded -- plus
    bit-identity vs the eager per-op reference (the identical dispatch
    sequence on plain tensors).  The reference's CI gates
    ``boundary_copies_per_block <= 1``, ``forwarded_per_prefill >= 1`` and
    ``bit_identical_to_eager`` (``run.py --gate``).  ``smoke`` serves the
    smoke config of paper-gpt2-124m, else its full config (12 layers,
    d_model 768, bf16 on the card).

    Beside the reference's numbers: the kernels' launches in one chained
    prefill (per path too), and host wall-clock µs of one synchronized
    prefill at the same (bp, sp) through the chain, the ``"aot"``
    program's captured graph (on the card) and its eager forward
    (``graphs=False``), all on the same weights."""
    from repro_torch.launch.serve import VortexServer
    from repro_torch.models.registry import get_config, get_smoke_config

    cfg = get_smoke_config("paper-gpt2-124m") if smoke \
        else get_config("paper-gpt2-124m")
    server = VortexServer(cfg, max_cache=256, device=device,
                          hardware=hardware, prefill="chained")
    rng = np.random.default_rng(29)
    bp, s = 1, 100
    sp = server.chain_seq_bucket(s, bp)
    tokens = rng.integers(0, cfg.vocab, (bp, s))
    padded = torch.zeros((bp, sp), dtype=torch.int64)
    padded[:, :s] = torch.from_numpy(tokens)
    padded = padded.to(server.device)

    def chain(eager=False):
        return server.prefill_chained(bp, sp, padded, last=s - 1,
                                      eager=eager)

    def sync():
        if server.device.type == "cuda":
            torch.cuda.synchronize(server.device)

    def chain_counters() -> dict:
        keys = (
            "stage_copies", "unstage_copies", "realize_slices", "forwarded",
        )
        out = dict.fromkeys(keys, 0)
        for kind, st in server.engine.stats().items():
            if kind == "calibration":  # engine-level section, not a kind
                continue
            for k in keys:
                out[k] += st[k]
        return out

    # Warm the per-bucket executables, then count over ONE prefill.
    chain()
    sync()
    before, k_before = chain_counters(), launch_counts()
    last, cache = chain()
    after, k_launched = chain_counters(), _delta(k_before, launch_counts())
    copies = sum(
        after[k] - before[k]
        for k in ("stage_copies", "unstage_copies", "realize_slices")
    )
    forwarded = after["forwarded"] - before["forwarded"]
    blocks = cfg.n_layers

    last_e, cache_e = chain(eager=True)
    leaves = [last] + [c[n] for c in cache.values() for n in ("k", "v")]
    leaves_e = [last_e] + [c[n] for c in cache_e.values() for n in ("k", "v")]
    max_abs = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(leaves, leaves_e))

    def host_us(fn) -> float:
        times = []
        for _ in range(3 if smoke else 10):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        return min(times) * 1e6

    # The "aot" program at the same bucket: its graph (captured on the
    # first call) and its eager forward, through ``prefill()``.
    aot = {}
    for name, graphs in (("graphed", None), ("eager", False)):
        srv = VortexServer(cfg, max_cache=256, params=server.params,
                           device=device, hardware=hardware, graphs=graphs)
        if name == "graphed" and srv.graphs is None:
            aot[name] = None  # the CPU has no graphs
            continue
        toks = np.zeros((bp, sp), np.int64)  # an aligned prompt of sp
        toks[:, :s] = tokens

        def one(srv=srv, toks=toks):
            srv.release_cache(srv.prefill(toks)[1])

        one()  # warm: executables (and the graph's capture)
        aot[name] = host_us(one)
    return {
        "arch": cfg.name,
        "seq_bucket": sp,
        "batch_bucket": bp,
        "prompt_len": s,
        "blocks_per_prefill": blocks,
        "chain_aligned": server._chain_aligned(bp, sp),
        "boundary_copies_per_block": copies / max(blocks, 1),
        "forwarded_per_prefill": forwarded,
        "kernel_launches_per_prefill": k_launched,
        "us_per_prefill": host_us(chain),
        "aot_graphed_us_per_prefill": aot["graphed"],
        "aot_eager_us_per_prefill": aot["eager"],
        "max_abs_diff_vs_eager": max_abs,
        "bit_identical_to_eager": max_abs == 0.0,
    }


def _bench_moe(smoke: bool, *, device="cuda",
               hardware: str = "h100_sxm") -> dict:
    """The MoE section: a granite-moe-1b-a400m expert-FFN layer served
    engine vs dense.  With a session installed, ``_expert_ffn`` makes its
    three projections three grouped-GEMM dispatches, each ONE bucketed
    masked-tail launch for all experts, with the per-expert token counts
    as the runtime extent vector.

    ``smoke`` runs the smoke config; otherwise granite's real expert
    widths (d_model 1024, d_ff_expert 512, 32 experts, top-8).
    ``launches_per_moe_layer`` is per projection: 1.0 means every
    projection ran as ONE grouped launch for all experts.  The engine's
    output is held against the dense einsums: bit-identical on the CPU
    (the plain versions), within ``MOE_TOL`` on the card (bf16).
    """
    from repro_torch import vortex
    from repro_torch.configs.granite_moe_1b import CONFIG, SMOKE
    from repro_torch.models import layers as Lyr

    cfg, (b, s) = (SMOKE, (2, 33)) if smoke else (CONFIG, (2, 96))
    m = cfg.moe
    dtype = dtype_for(device)
    rng = np.random.default_rng(41)

    def mk(*sh, scale=0.05):
        return randn(rng, sh, device, scale=scale)

    p = {
        "router": mk(cfg.d_model, m.num_experts),
        "w_in": mk(m.num_experts, cfg.d_model, m.d_ff_expert),
        "w_gate": mk(m.num_experts, cfg.d_model, m.d_ff_expert),
        "w_out": mk(m.num_experts, m.d_ff_expert, cfg.d_model),
    }
    x = mk(b, s, cfg.d_model, scale=1.0)

    def layer_call():
        return Lyr.moe_forward(p, x, cfg)[0]

    y_dense = synchronize(layer_call())
    rounds = dict(
        inner=1, min_rounds=3 if smoke else 10,
        max_rounds=10 if smoke else 40, patience=3,
    )
    # Dense timing OUTSIDE the session: the same moe_forward with and
    # without the grouped-GEMM dispatch path.
    dense_us = interleaved_minima([layer_call], **rounds).best_s[0] * 1e6

    eng = Engine(hardware, device=device,
                 empirical_levels=(() if smoke else None))
    keys = ("launches", "padded_calls", "stage_copies")
    with vortex.use(eng):
        y_eng = synchronize(layer_call())  # warm: kernel build, buckets
        before = {k: eng.stats()["grouped_gemm"][k] for k in keys}
        k_before = _kernel_totals()
        layer_calls = 4 if smoke else 8
        for _ in range(layer_calls):
            synchronize(layer_call())
        after = {k: eng.stats()["grouped_gemm"][k] for k in keys}
        k_launched = _delta(k_before, _kernel_totals())
        engine_us = interleaved_minima([layer_call], **rounds).best_s[0] * 1e6

    launches = after["launches"] - before["launches"]
    diff = (y_eng.float() - y_dense.float()).abs().max().item()
    rel = diff / max(y_dense.float().abs().max().item(), 1e-6)
    dropped = float(Lyr.moe_forward(p, x, cfg)[2])
    return {
        "experts": m.num_experts,
        "top_k": m.top_k,
        "d_model": cfg.d_model,
        "d_ff_expert": m.d_ff_expert,
        "dtype": str(dtype).replace("torch.", ""),
        "tokens": b * s,
        "layer_calls": layer_calls,
        "launches_per_moe_layer": launches / (3 * layer_calls),
        "kernel_launches_per_moe_layer": (
            k_launched.get("vortex_grouped_gemm", 0) / (3 * layer_calls)
        ),
        "padded_calls": after["padded_calls"],
        "stage_copies": after["stage_copies"] - before["stage_copies"],
        "dropped_frac": dropped,
        "engine_us_per_layer": engine_us,
        "dense_us_per_layer": dense_us,
        "max_abs_diff_vs_dense": diff,
        "max_rel_diff_vs_dense": rel,
        "tolerance": MOE_TOL[dtype],
        "within_tolerance": rel <= MOE_TOL[dtype],
        "bit_identical_to_dense": diff == 0.0,
    }


def _bench_calibration(smoke: bool, *, device="cuda",
                       hardware: str = "h100_sxm") -> dict:
    """The background-calibration section (the reference's
    ``_bench_calibration``): a gemm engine runs one full calibration pass
    (top-K candidates timed per bucket, fit or re-rank, table swap), then
    reports measured-vs-analytical agreement and the calibrated pick's
    regret per bucket; a FRESH engine on the same cache directory then
    loads the persisted tables.  ``run.py --gate`` checks
    ``never_worse_on_measured`` and ``measured_buckets >= 1`` per kind,
    and the roundtrip: at least one table loaded, zero re-measurements,
    nothing pending.  The tables persist in a temporary directory that is
    removed afterwards.  On the card the gemm is bf16 through the
    hand-written kernel."""
    import dataclasses
    import tempfile

    with tempfile.TemporaryDirectory(prefix="vortex-bench-calib-") as cache:

        def fresh_engine() -> Engine:
            eng = Engine(
                hardware, device=device, empirical_levels=(),
                calibration="on-idle",
                calibration_top_k=2 if smoke else 3,
                calibration_cache_dir=cache,
            )
            rng = np.random.default_rng(11)
            eng.dispatch("gemm", randn(rng, (33, 256), device),
                         randn(rng, (256, 128), device))
            cal = eng.calibrator
            # Bench-sized plan; the policy steers kernel states planned
            # from here on, so it is set before the first slice.
            cal.policy = dataclasses.replace(
                cal.policy,
                m_max=192 if smoke else 512,
                max_buckets=3 if smoke else 6,
                min_rounds=3 if smoke else 8,
                max_rounds=8 if smoke else 24,
                patience=2 if smoke else 4,
            )
            return eng

        cal = fresh_engine().calibrator
        t0 = time.perf_counter()
        cal.run()
        calibrate_s = time.perf_counter() - t0
        report = cal.report()
        cal2 = fresh_engine().calibrator
        loaded = cal2.load()
        roundtrip = {
            "loaded": loaded,
            "re_measurements": cal2.counters["measurements"],
            "pending_after_load": cal2.pending(),
            "table_swaps": cal2.counters["table_swaps"],
        }
    return {
        "kinds": report,
        "roundtrip": roundtrip,
        "calibrate_s": calibrate_s,
        "stats": cal.stats(),
    }


def _touch_kinds(eng, device) -> None:
    """One signature per kind, so the dispatch section sees all three."""
    rng = np.random.default_rng(0)

    def arr(*shape):
        return randn(rng, shape, device)

    eng.dispatch("gemm", arr(33, 768), arr(768, 768))
    kv = arr(1, 2, 67, 64)
    eng.dispatch("attention", arr(1, 4, 67, 64), kv, kv)
    eng.dispatch("conv2d", arr(2, 28, 28, 16), arr(3, 3, 16, 32))


def serving_payload(smoke: bool, *, device="cuda",
                    hardware: str = "h100_sxm") -> dict:
    """The BENCH_serving_torch.json payload (``run.py --json``): dispatch
    overhead on unseen shapes, the aligned-vs-unaligned hot-path ratio and
    copies/launches per call (with raw per-round samples), the serving
    decode contract, the continuous-batching contract and the MoE
    grouped-GEMM contract, the chained prefill's boundary-copy contract
    (``prefill_chain``), with the card's name and power limit;
    ``run.py --json`` adds the ``calibration`` section
    (:func:`_bench_calibration`) beside these."""
    eng = Engine(hardware, device=device,
                 empirical_levels=(() if smoke else None))
    _touch_kinds(eng, device)
    kw = dict(device=device, hardware=hardware)
    return {
        "mode": "smoke" if smoke else "full",
        "device": str(torch.device(device)),
        "hardware": hardware,
        "card": card_line(device),
        "dispatch": _bench_dispatch(eng, get_hardware(hardware), smoke),
        "hot_path": _bench_hot_path(smoke, **kw),
        "decode": _bench_decode(smoke, **kw),
        "continuous_batching": _bench_continuous_batching(smoke, **kw),
        "prefill_chain": _bench_prefill_chain(smoke, **kw),
        "moe": _bench_moe(smoke, **kw),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced stream + analytical-only offline stage")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write per-kind dispatch results as JSON")
    ap.add_argument("--no-hot-path", action="store_true",
                    help="skip the aligned-vs-unaligned hot-path section")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hardware", default="h100_sxm")
    args = ap.parse_args()

    device = args.device
    eng = Engine(args.hardware, device=device,
                 empirical_levels=(() if args.smoke else None))
    hw = get_hardware(args.hardware)
    rng = np.random.default_rng(0)
    gemm_ms = GEMM_MS[:3] if args.smoke else GEMM_MS
    attn_seqs = ATTN_SEQS[:2] if args.smoke else ATTN_SEQS
    conv_batches = CONV_BATCHES[:2] if args.smoke else CONV_BATCHES

    def arr(*shape):
        return randn(rng, shape, device)

    # Each stream is served once untimed (kernel library build, buckets),
    # then timed: the dispatch streams' steady state.
    N, K = 768, 768
    b = arr(K, N)
    mats = {m: arr(m, K) for m in gemm_ms}
    gemm_calls = [
        (lambda a=mats[m]: eng.dispatch("gemm", a, b)) for m in gemm_ms * 2
    ]
    qkv = {s: (arr(1, 8, s, 64), arr(1, 4, s, 64), arr(1, 4, s, 64))
           for s in attn_seqs}
    attn_calls = [
        (lambda t=qkv[s]: eng.dispatch("attention", *t)) for s in attn_seqs * 2
    ]
    wconv = arr(3, 3, 16, 32)
    xs = {bs: arr(bs, 28, 28, 16) for bs in conv_batches}
    conv_calls = [
        (lambda x=xs[bs]: eng.dispatch("conv2d", x, wconv))
        for bs in conv_batches * 2
    ]
    streams = {"gemm": gemm_calls, "attention": attn_calls,
               "conv2d": conv_calls}
    wall = {}
    for kind, calls in streams.items():
        _bench(calls)
        wall[kind] = _bench(calls) * 1e6

    stats = eng.stats()
    stats.pop("calibration", None)  # engine-level section, not a kind
    for kind, s in stats.items():
        selects = max(s["selects"], 1)
        misses = s["select_argmin_misses"]
        miss_us = f"{s['select_us_sum'] / misses:.1f}" if misses else "n/a"
        emit(
            f"workloads/{kind}", wall[kind],
            f"argmin_miss_us={miss_us};"
            f"table_hit_rate={s['select_table_hits'] / selects:.2f};"
            f"lru_hits={s['select_lru_hits']};"
            f"argmin_misses={s['select_argmin_misses']};"
            f"table_entries={s['table_entries']};"
            f"exec_entries={s['exec_entries']};"
            f"exec_hits={s['exec_hits']};"
            f"compile_s={s['compile_seconds']:.2f}",
        )
    total_exec = sum(s["exec_entries"] for s in stats.values())
    total_calls = sum(s["exec_hits"] for s in stats.values())
    emit(
        "workloads/summary", 0.0,
        f"executables={total_exec};calls_served={total_calls};"
        f"amortization={total_calls / max(total_exec, 1):.1f}x",
    )

    dispatch = _bench_dispatch(eng, hw, args.smoke)
    for kind, d in dispatch.items():
        emit(
            f"dispatch/{kind}", d["table_us"],
            f"argmin_us={d['argmin_us']:.1f};speedup={d['speedup']:.1f}x;"
            f"table_entries={d['table_entries']};"
            f"table_build_ms={d['table_build_s'] * 1e3:.1f}",
        )

    hot = {} if args.no_hot_path else _bench_hot_path(
        args.smoke, device=device, hardware=args.hardware)
    for kind, h in hot.items():
        emit(
            f"hot_path/{kind}", h["unaligned_us"],
            f"aligned_us={h['aligned_us']:.1f};"
            f"ratio={h['unaligned_over_aligned']:.3f};"
            f"launches_per_call={h['launches_per_call']:.2f};"
            f"kernel_launches_per_call={h['kernel_launches_per_call']:.2f};"
            f"copies_per_unaligned_call={h['copies_per_unaligned_call']:.1f};"
            f"folded_per_unaligned_call={h['folded_per_unaligned_call']:.1f};"
            f"padded_calls={h['padded_calls']}",
        )

    calibration = _bench_calibration(args.smoke, device=device,
                                     hardware=args.hardware)
    for kind, c in calibration["kinds"].items():
        emit(
            f"calibration/{kind}", c["mean_regret_vs_best"] * 1e2,
            f"mode={c['mode']};agreement={c['agreement_rate']:.2f};"
            f"pinned={c['pinned_buckets']}/{c['measured_buckets']};"
            f"never_worse={c['never_worse_on_measured']};"
            f"residual={c['residual']:.3f}",
        )
    rt = calibration["roundtrip"]
    emit(
        "calibration/roundtrip", calibration["calibrate_s"] * 1e6,
        f"loaded={rt['loaded']};re_measurements={rt['re_measurements']};"
        f"pending_after_load={rt['pending_after_load']}",
    )

    if args.json:
        payload = {
            "card": card_line(device),
            "device": str(torch.device(device)),
            "hardware": args.hardware,
            "dispatch": dispatch,
            "hot_path": hot,
            "calibration": calibration,
            "serving": {
                kind: {
                    "selects": s["selects"],
                    "table_hit_rate": (
                        s["select_table_hits"] / max(s["selects"], 1)
                    ),
                    "argmin_misses": s["select_argmin_misses"],
                    "exec_entries": s["exec_entries"],
                    "launches": s["launches"],
                    "stage_copies": s["stage_copies"],
                    "unstage_copies": s["unstage_copies"],
                    "padded_calls": s["padded_calls"],
                    "wall_us_per_call": wall[kind],
                }
                for kind, s in stats.items()
            },
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
