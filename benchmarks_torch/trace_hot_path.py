"""Where the hot path's host time goes (ROADMAP C4): one engine call of each
kind traced per operation, aligned against unaligned.

The cases are ``bench_workloads._bench_hot_path``'s (a bf16 GEMM 2304
wide, prefill attention with 8/4 heads of 64, a 1x1 conv2d 1536 wide),
each at the aligned extent (the bucket itself: zero-copy launch) and at
the largest unaligned extent the same executable serves (on the card one
launch on the operands at their true extents; a tree from before that
change stages them, launches masked and slices the output back).

First the untraced steady state: host wall-clock per synchronized call,
interleaved min-vs-min (``core/timing.py``), the ratio the gate reads.
Then the same calls under ``torch.profiler`` (CPU and CUDA activities),
with ``record_function`` ranges wrapped around the dispatch engine's
steps -- select, ``_entry_for``, ``stage_view``, ``runtime_scalars``,
``staged_shapes``, the check whether the launch reads the operands in
place, the pool's ``acquire`` and ``release``, each operand's staging
copy, the launch and ``finalize`` -- so each step's host µs per
call (the range's CPU time over the calls) stands beside the aten
operators it issued.  The profiler adds its own cost to every range: read
the per-step numbers against each other, and the untraced wall-clock for
the total.  Wraps whichever of these the engine has, so the script also
traces an older tree (run it from that tree's ``benchmarks_torch/``).

    python benchmarks_torch/trace_hot_path.py --json trace.json
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks_torch.bench_workloads import (  # noqa: E402
    HOT_WIDTHS,
    _attn_aligned_seq,
    _same_entry_unaligned,
)
from benchmarks_torch.util import card_line, randn  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core import workloads as wl_mod  # noqa: E402
from repro_torch.core.selector import RuntimeSelector  # noqa: E402
from repro_torch.core.timing import interleaved_minima, synchronize  # noqa: E402
from repro_torch.vortex import Engine  # noqa: E402

# (owner, attribute, range name): the dispatch engine's steps.
_STEPS = (
    (RuntimeSelector, "select", "select"),
    (engine_mod.VortexKernel, "_entry_for", "_entry_for"),
    (engine_mod._CacheEntry, "run", "launch"),
    ("_StagingPool", "acquire", "acquire"),
    ("_StagingPool", "release", "release"),
    ("_BufferSet", "stage", "stage_copy"),
)
_WORKLOAD_STEPS = ("stage_view", "runtime_scalars", "staged_shapes",
                   "finalize")
_MODULE_FUNCS = (("_stage_into", "stage_copy"),
                 ("_launch_folds", "fold_check"))


def _ranged(fn, name: str):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def instrument() -> list[str]:
    """Wrap every step the engine has in a ``record_function`` range;
    returns the range names installed."""
    names = []
    for owner, attr, name in _STEPS:
        if isinstance(owner, str):
            owner = getattr(engine_mod, owner, None)
        if owner is not None and hasattr(owner, attr):
            setattr(owner, attr, _ranged(getattr(owner, attr), name))
            names.append(name)
    for cls in (wl_mod.GemmWorkload, wl_mod.AttentionWorkload,
                wl_mod.Conv2dWorkload):
        for attr in _WORKLOAD_STEPS:
            setattr(cls, attr, _ranged(getattr(cls, attr), attr))
    names += list(_WORKLOAD_STEPS)
    for attr, name in _MODULE_FUNCS:
        if hasattr(engine_mod, attr):
            setattr(engine_mod, attr, _ranged(getattr(engine_mod, attr), name))
            names.append(name)
    return sorted(set(names))


def cases(device: str) -> dict:
    """Per kind: (aligned call, unaligned call, (aligned, unaligned)
    extents), as ``_bench_hot_path`` builds them at full width."""
    eng = Engine("h100_sxm", device=device, empirical_levels=())
    rng = np.random.default_rng(3)
    gw, cw = HOT_WIDTHS[False]

    def arr(shape):
        return randn(rng, shape, device)

    out = {}
    gk = eng.op_kernel("gemm", (arr((8, gw)), arr((gw, gw))), {})
    gb = gk.select(381).padded_m
    gu = _same_entry_unaligned(gk, gb)
    wg = arr((gw, gw))
    ga, gua = arr((gb, gw)), arr((gu, gw))
    out["gemm"] = (lambda: eng.dispatch("gemm", ga, wg),
                   lambda: eng.dispatch("gemm", gua, wg), (gb, gu))
    q0 = (arr((2, 8, 8, 64)), arr((2, 4, 8, 64)), arr((2, 4, 8, 64)))
    ak = eng.op_kernel("attention", q0, {})
    sa = _attn_aligned_seq(ak, 199)
    su = _same_entry_unaligned(ak, sa)

    def attn_args(s):
        return (arr((2, 8, s, 64)), arr((2, 4, s, 64)), arr((2, 4, s, 64)))

    aa, au = attn_args(sa), attn_args(su)
    out["attention"] = (lambda: eng.dispatch("attention", *aa),
                        lambda: eng.dispatch("attention", *au), (sa, su))
    ck = eng.op_kernel("conv2d", (arr((1, 1, 8, cw)), arr((1, 1, cw, cw))),
                       {})
    cb = ck.select(500).padded_m
    cu = _same_entry_unaligned(ck, cb)
    wc = arr((1, 1, cw, cw))
    xa, xu = arr((1, 1, cb, cw)), arr((1, 1, cu, cw))
    out["conv2d"] = (lambda: eng.dispatch("conv2d", xa, wc),
                     lambda: eng.dispatch("conv2d", xu, wc), (cb, cu))
    return out


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def trace_call(call, calls: int, ranges: list[str]) -> dict:
    """One path under the profiler: per range and per aten operator, the
    host µs per call (CPU time including children) and the calls' count;
    the device µs per call of every CUDA kernel and copy."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            with torch.profiler.record_function("call"):
                synchronize(call())
    host, aten, device = {}, {}, {}
    for evt in prof.key_averages():
        per_call = evt.cpu_time_total / calls
        if evt.key in ranges or evt.key == "call":
            # A range that issued device work also has a device-side
            # annotation of the same name, with no CPU time: keep the
            # host one.
            if per_call >= host.get(evt.key, {}).get("us", 0.0):
                host[evt.key] = {"us": per_call, "count": evt.count / calls}
        elif evt.key.startswith(("aten::", "cuda")):
            aten[evt.key] = {"us": per_call, "self_us":
                             evt.self_cpu_time_total / calls,
                             "count": evt.count / calls}
        dev = _device_us(evt)
        if dev and not evt.key.startswith(("aten::", "call")) \
                and evt.key not in ranges:
            device[evt.key] = dev / calls
    return {"host": host, "aten": aten, "device": device}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("trace_hot_path: no CUDA device", file=sys.stderr)
        return 1
    card = card_line(args.device)
    built = cases(args.device)
    result = {"card": card, "calls": args.calls, "kinds": {}}
    # Untraced steady state first (no wrappers installed yet).
    for kind, (aligned, unaligned, ext) in built.items():
        for fn in (aligned, unaligned):
            for _ in range(20):
                synchronize(fn())
        t = interleaved_minima([aligned, unaligned], inner=2, min_rounds=30,
                               max_rounds=120, patience=10)
        result["kinds"][kind] = {
            "extents": {"aligned": ext[0], "unaligned": ext[1]},
            "wall_us": {"aligned": t.best_s[0] * 1e6,
                        "unaligned": t.best_s[1] * 1e6},
            "ratio": t.ratio(1, 0),
        }
    ranges = instrument()
    for kind, (aligned, unaligned, _) in built.items():
        r = result["kinds"][kind]
        for path, fn in (("aligned", aligned), ("unaligned", unaligned)):
            trace_call(fn, 20, ranges)  # the profiler's own first use
            r[path] = trace_call(fn, args.calls, ranges)
    for kind, r in result["kinds"].items():
        print(f"{kind}: extents {r['extents']} untraced wall "
              f"aligned {r['wall_us']['aligned']:.2f} us unaligned "
              f"{r['wall_us']['unaligned']:.2f} us ratio {r['ratio']:.4f} "
              f"on {card}")
        names = sorted(set(r["aligned"]["host"]) | set(r["unaligned"]["host"]))
        for name in names:
            a = r["aligned"]["host"].get(name, {}).get("us", 0.0)
            u = r["unaligned"]["host"].get(name, {}).get("us", 0.0)
            print(f"  range {name:16s} aligned {a:8.2f} us  unaligned "
                  f"{u:8.2f} us  (traced host µs per call)")
        ops = sorted(set(r["aligned"]["aten"]) | set(r["unaligned"]["aten"]))
        for name in ops:
            a = r["aligned"]["aten"].get(name, {})
            u = r["unaligned"]["aten"].get(name, {})
            print(f"  op    {name:28s} aligned {a.get('us', 0.0):8.2f} us "
                  f"x{a.get('count', 0.0):.0f}  unaligned "
                  f"{u.get('us', 0.0):8.2f} us x{u.get('count', 0.0):.0f}")
        for path in ("aligned", "unaligned"):
            dev = r[path]["device"]
            print(f"  device {path}: "
                  + ", ".join(f"{k[:48]} {v:.2f} us" for k, v in
                              sorted(dev.items(), key=lambda kv: -kv[1])[:6]))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1,
                                              sort_keys=True))
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
