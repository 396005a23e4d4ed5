"""Benchmark runner of the port — one module per paper table/figure
(counterpart of benchmarks/run.py).

Each prints ``name,us_per_call,derived`` CSV lines (benchmarks_torch/util.emit).

  bench_gemm             Fig. 12 / Table 5  operator-level speedups
  bench_offsample        Fig. 3  / Table 6  off-sample degradation
  bench_compile_time     §7.4               offline overhead
  bench_hierarchy        Fig. 15            static/dynamic ablation
  bench_analyzer         Table 7            hybrid analyzer configs
  bench_adaptive         Fig. 16            tensor core / CUDA core adaptation
  bench_runtime_overhead Fig. 14            selection overhead
  bench_workloads        §4 generality      gemm/attention/conv one engine
  bench_models           Fig. 13            model-level dynamic shapes

Everything runs on the card; ``--device cpu`` is forwarded to the modules
and runs the plain versions.

``--json PATH`` writes the serving snapshot
(``bench_workloads.serving_payload``; the port's file is
``BENCH_serving_torch.json`` at the repo root — the reference's
``BENCH_serving.json`` is never written from here), with the calibration
section (``bench_workloads._bench_calibration``) beside it.  With ``--json`` the
module loop is skipped unless a module filter is also given.  ``--gate``
checks the reference's CI gates on the payload (``--json``'s, or the file
named by ``--check``) and exits nonzero when one fails:

    python benchmarks_torch/run.py                       # every module
    python benchmarks_torch/run.py --json BENCH_serving_torch.json --gate
    python benchmarks_torch/run.py --check BENCH_serving_torch.json --gate
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

MODULES = [
    "bench_compile_time",
    "bench_runtime_overhead",
    "bench_adaptive",
    "bench_analyzer",
    "bench_gemm",
    "bench_workloads",
    "bench_offsample",
    "bench_hierarchy",
    "bench_models",
]

# The reference's gates (its CI's bench-smoke job), keyed by name.
HOT_PATH_RATIO = 1.10
DISPATCH_SPEEDUP = 5.0
SPEEDUP_AT_16 = 1.5


def gate_failures(payload: dict) -> list[str]:
    """Every gate the payload breaks, one line each (empty: all hold).

    The structural gates (launches, padded calls, decode steps) are exact;
    the wall-clock ones are the reference's bounds on the ratios the bench
    measured with ``retry_best``; the chained prefill's three are the
    reference's (boundary copies per block, forwarded operands, bit-identity
    to the eager per-op reference).  On the card the MoE output is held
    against the dense einsums within the grouped GEMM's bf16 tolerance
    (``within_tolerance``); on the CPU, where both sides are plain
    PyTorch, it must be bit-identical as the reference's gate asks.  The
    calibration gates are the reference's: per kind, the calibrated pick
    never slower than the analytical one on a measured bucket and at least
    one bucket measured; a fresh engine loads the persisted tables with
    zero re-measurements and nothing left pending."""
    out: list[str] = []

    def need(ok: bool, what: str) -> None:
        if not ok:
            out.append(what)

    cal = payload.get("calibration")
    if cal is None:
        out.append("calibration: the snapshot has no calibration section")
    else:
        need(bool(cal["kinds"]), "calibration: no kind was calibrated")
        for kind, r in cal["kinds"].items():
            # On every measured bucket the calibrated table's pick is at
            # least as fast (by the measurements) as the analytical pick.
            need(r["never_worse_on_measured"],
                 f"calibration/{kind}: the calibrated pick is slower than "
                 f"the analytical pick on a measured bucket")
            need(r["measured_buckets"] >= 1,
                 f"calibration/{kind}: {r['measured_buckets']} measured "
                 f"buckets")
        rt = cal["roundtrip"]
        # A fresh engine with the same hardware fingerprint loads the
        # calibrated tables with zero re-measurements.
        need(rt["loaded"] >= 1 and rt["re_measurements"] == 0
             and not rt["pending_after_load"],
             f"calibration/roundtrip: loaded {rt['loaded']}, "
             f"{rt['re_measurements']} re-measurements, pending after load "
             f"{rt['pending_after_load']}")
    for kind, r in payload["dispatch"].items():
        need(r["speedup"] >= DISPATCH_SPEEDUP,
             f"dispatch/{kind}: table select {r['speedup']:.2f}x faster than "
             f"argmin < {DISPATCH_SPEEDUP}x")
    for kind, r in payload["hot_path"].items():
        need(r["launches_per_call"] == 1.0,
             f"hot_path/{kind}: launches_per_call {r['launches_per_call']}")
        need(r["padded_calls"] == 0,
             f"hot_path/{kind}: padded_calls {r['padded_calls']}")
        need(r["unaligned_over_aligned"] <= HOT_PATH_RATIO,
             f"hot_path/{kind}: unaligned/aligned "
             f"{r['unaligned_over_aligned']:.4f} > {HOT_PATH_RATIO}")
        need(r["fallbacks"] == 0 and r["quarantined"] == 0,
             f"hot_path/{kind}: fallbacks {r['fallbacks']} quarantined "
             f"{r['quarantined']}")
    dec = payload["decode"]
    need(dec["launches_per_token"] == 1.0,
         f"decode: {dec['launches_per_token']} decode steps per token")
    need(dec["padded_calls"] == 0, f"decode: padded_calls {dec['padded_calls']}")
    need(dec["engine_padded_calls"] == 0,
         f"decode: engine padded_calls {dec['engine_padded_calls']}")
    cb = payload["continuous_batching"]
    need(cb["launches_per_batched_step"] == 1.0,
         f"continuous_batching: {cb['launches_per_batched_step']} decode "
         f"steps per batched step")
    need(cb["padded_calls"] == 0,
         f"continuous_batching: padded_calls {cb['padded_calls']}")
    for name, r in (("decode", dec), ("continuous_batching", cb)):
        # With graphs on, every decode step of a timed window replays a
        # graph captured before it.
        need(not r["graphs"] or (
            r["decode_graph_captures"] == 0
            and r["decode_graph_replays"] == r["timed_steps"]),
             f"{name}: {r['decode_graph_captures']} graph captures and "
             f"{r['decode_graph_replays']} replays for {r['timed_steps']} "
             f"decode steps in the timed windows")
    need(cb["speedup_at_16"] >= SPEEDUP_AT_16,
         f"continuous_batching: speedup_at_16 {cb['speedup_at_16']:.3f} < "
         f"{SPEEDUP_AT_16}")
    pc = payload.get("prefill_chain")
    if pc is None:
        out.append("prefill_chain: the snapshot has no prefill_chain section")
    else:
        # The lazy-handle chain contract: a whole-model prefill crosses
        # every engine boundary without an unstage+restage pair (zero
        # boundary copies at a chain-aligned bucket; <= 1/block is the
        # hard ceiling), forwards at least once, and stays bit-identical
        # to the eager per-op reference.
        need(pc["boundary_copies_per_block"] <= 1,
             f"prefill_chain: {pc['boundary_copies_per_block']} boundary "
             f"copies per block > 1")
        need(pc["forwarded_per_prefill"] >= 1,
             f"prefill_chain: {pc['forwarded_per_prefill']} forwarded "
             f"operands per prefill < 1")
        need(pc["bit_identical_to_eager"],
             f"prefill_chain: max |chain - eager| "
             f"{pc['max_abs_diff_vs_eager']} (must be bit-identical)")
    moe = payload["moe"]
    need(moe["launches_per_moe_layer"] == 1,
         f"moe: launches_per_moe_layer {moe['launches_per_moe_layer']}")
    need(moe["padded_calls"] == 0, f"moe: padded_calls {moe['padded_calls']}")
    if payload["device"] == "cpu":
        need(moe["bit_identical_to_dense"],
             f"moe: max |engine - dense| {moe['max_abs_diff_vs_dense']} on "
             f"the CPU (must be bit-identical)")
    else:
        need(moe["within_tolerance"],
             f"moe: relative diff vs dense {moe['max_rel_diff_vs_dense']:.3g} "
             f"> {moe['tolerance']:.3g}")
    return out


def print_gates(payload: dict) -> list[str]:
    """Print the gated numbers and every failure; return the failures."""
    print(f"card: {payload.get('card')}")
    for kind, r in payload["hot_path"].items():
        print(f"hot_path/{kind}: aligned {r['aligned_us']:.1f}us vs "
              f"unaligned {r['unaligned_us']:.1f}us (ratio "
              f"{r['unaligned_over_aligned']:.3f} after "
              f"{r['gate_attempts']} attempts), "
              f"{r['launches_per_call']:.2f} launches/call")
    dec, cb = payload["decode"], payload["continuous_batching"]
    print(f"decode: {dec['tokens']} tokens, {dec['launches_per_token']:.2f} "
          f"steps/token, {dec['decode_us_per_token']:.0f}us/token")
    print(f"continuous_batching: serial {cb['serial_tokens_per_s']:.0f} tok/s, "
          f"speedup@16 {cb['speedup_at_16']:.2f}x")
    pc = payload.get("prefill_chain")
    if pc is not None:
        print(f"prefill_chain: sp={pc['seq_bucket']} "
              f"aligned={pc['chain_aligned']} "
              f"{pc['boundary_copies_per_block']:.2f} copies/block, "
              f"{pc['forwarded_per_prefill']} forwarded, "
              f"{pc['us_per_prefill']:.0f}us/prefill, "
              f"max|d|={pc['max_abs_diff_vs_eager']:.3g}")
    cal = payload.get("calibration") or {"kinds": {}}
    for kind, r in cal["kinds"].items():
        print(f"calibration/{kind}: mode={r['mode']} "
              f"agreement={r['agreement_rate']:.2f} "
              f"pinned={r['pinned_buckets']}/{r['measured_buckets']} "
              f"regret={r['mean_regret_vs_best']:.4f} "
              f"never_worse={r['never_worse_on_measured']}")
    failures = gate_failures(payload)
    for f in failures:
        print(f"GATE FAILED: {f}")
    print("gates: " + ("all hold" if not failures
                       else f"{len(failures)} failed"))
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("filter", nargs="?", default=None,
                    help="substring filter over benchmark module names")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced streams / analytical-only offline stage")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the serving snapshot (BENCH_serving_torch.json)")
    ap.add_argument("--check", metavar="PATH", default=None,
                    help="read a serving snapshot instead of measuring one")
    ap.add_argument("--gate", action="store_true",
                    help="assert the reference's CI gates on the snapshot")
    ap.add_argument("--device", default="cuda")
    args, passthrough = ap.parse_known_args(argv)
    if args.json and args.filter:
        ap.error(
            "--json writes the serving payload and cannot be combined with "
            "a module filter; invoke the module directly for its own JSON "
            "(e.g. benchmarks_torch/bench_workloads.py --json ...)"
        )
    if args.gate and not (args.json or args.check):
        ap.error("--gate needs a snapshot: --json PATH or --check PATH")

    failures = 0
    if args.filter is not None or (args.json is None and args.check is None):
        # Module mains parse sys.argv themselves: they see the device and,
        # when a filter names the modules, --smoke, plus any passthrough.
        fwd = ["--device", args.device]
        fwd += ["--smoke"] if args.smoke and args.filter else []
        saved = sys.argv
        sys.argv = [saved[0]] + fwd + passthrough
        print("name,us_per_call,derived")
        try:
            for name in MODULES:
                if args.filter and args.filter not in name:
                    continue
                t0 = time.perf_counter()
                print(f"# --- {name} ---", flush=True)
                try:
                    importlib.import_module(f"benchmarks_torch.{name}").main()
                except Exception:
                    failures += 1
                    traceback.print_exc()
                print(f"# {name} done in {time.perf_counter() - t0:.1f}s",
                      flush=True)
        finally:
            sys.argv = saved

    payload = None
    if args.json:
        from benchmarks_torch.bench_workloads import (
            _bench_calibration,
            serving_payload,
        )

        payload = serving_payload(args.smoke, device=args.device)
        payload["calibration"] = _bench_calibration(args.smoke,
                                                    device=args.device)
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    elif args.check:
        with open(args.check) as f:
            payload = json.load(f)
    if args.gate and print_gates(payload):
        failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
