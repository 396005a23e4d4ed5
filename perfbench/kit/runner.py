"""One run of one cell: set up, measure, read the metrics, free the
program, judge, and assemble the result line."""
from __future__ import annotations

import json
import subprocess
import time

import torch

from kit import judge, program_trace, spec
from kit.gemm_stream import GemmRun
from kit.serving import ServeRun, sync


class Context:
    """What a metric's reader sees: the run, its model, its set-up time,
    the traced slice (None with ``--trace 0``) and the port's own records
    (``kit/program_trace.py``; None unless a reader asks for them)."""

    def __init__(self, run, model: dict | None, setup_s: float):
        self.run, self.model, self.setup_s = run, model, setup_s
        self.trace = run.trace.read() if run.trace is not None else None
        self.program = program_trace.read(run)

    def window_steps(self):
        r = self.run
        return [s for s in r.steps if r.t_window <= s.t0 < r.t_close]

    def window_prefills(self):
        r = self.run
        return [p for p in r.prefills if r.t_window <= p.t0 < r.t_close]

    def slice_steps(self):
        a, b = self.run.slice_steps
        return self.run.steps[a:b]

    def slice_prefills(self):
        a, b = self.run.slice_prefills
        return self.run.prefills[a:b]

    def slice_calls(self):
        a, b = self.run.slice_calls
        return self.run.calls[a:b]


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(cell: spec.Cell, args, t_start: float, device: str = "cuda") -> dict:
    """``device="cpu"`` is for the CPU tests: the port's plain versions at
    a smoke size, no trace, no device readings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = cell.mix["kind"]
    st = cell.settings
    program = spec.wants_program(cell, bool(args.trace))
    if kind == "gemm_stream":
        r = GemmRun(cell.conf, st, cell.mix, args.seed, args.seconds,
                    bool(args.trace), device=device, program=program)
    else:
        r = ServeRun(cell.conf, st, cell.mix, args.seed, args.seconds,
                     bool(args.trace), rate=args.rate, device=device,
                     program=program)
    t_setup = time.perf_counter()
    r.setup()
    sync(device)
    t_run = time.perf_counter()
    r.run()
    # Set-up ends where the window starts (after a serving cell's
    # pre-roll).
    setup_s = r.t_window - t_start
    cuda = device != "cpu"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = Context(r, cell.conf.get("model"), setup_s)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"attempted": 0, "failed": 0}
    notes = [f"perfbench: {cell.name} seed {args.seed} on {dev['kind']}, "
             f"power limit {power_limit() if cuda else 'none'}",
             "perfbench: set-up phases (s): " + ", ".join(
                 f"{k} {v:.3f}" for k, v in [
                     ("start", t_setup - t_start), *r.setup_phases.items(),
                     ("preroll", r.t_window - t_run)])]
    if ctx.trace is not None:
        t = ctx.trace
        dev["busy_s"] = t.busy_us * 1e-6
        dev["window_s"] = t.window_us * 1e-6
        out["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps":
                            t.idle_gaps()}
        if kind != "gemm_stream":
            notes.append(f"perfbench: traced slice: {t.window_us * 1e-6:.3f}"
                         f" s, {len(ctx.slice_steps())} decode steps, "
                         f"{len(ctx.slice_prefills())} prefills")
        for name, pat in (
                ("decode attention", r"::attn_decode_kernel<"),
                ("prefill attention", r"::attn_(tc_)?kernel<"),
                ("gemm / grouped gemm",
                 r"::tc_gemm_kernel<|::gemm_kernel<|::grouped_gemm_kernel<")):
            us, n, names = t.kernel_us(pat)
            notes.append(f"perfbench: kernels matched as {name}: {n} "
                         f"launches, {us:.1f} us, {names}")
    if args.dump:
        dump(r, args.dump)
    if kind == "gemm_stream":
        out["attempted"] = len(r.calls)
        r.free()
        numbers, ctl = judge.gemm_checks(r, bool(args.control))
    else:
        out["attempted"] = len(r.reqs)
        out["failed"] = sum(q.out is None for q in r.reqs)
        notes.append(f"perfbench: graphs captured after set-up: "
                     f"{r.window_captures}")
        r.free()
        numbers, ctl = judge.serve_checks(r, args.seed, bool(args.control))
    limits = cell.settings["limits"]
    program = judge.limited(numbers, limits)
    # With the control, its readings stand in the program's place.
    checks = judge.limited({**numbers, **ctl}, limits)
    notes += [f"perfbench: not compared: {k} {v!r}"
              for k, (v, lim) in checks.items() if lim is None]
    if args.control:
        notes += [f"perfbench: program: {k} {v!r} limit {lim!r}"
                  for k, (v, lim) in program.items()]
        out["program_correct"] = judge.verdict(program)
    return {
        "notes": notes,
        "correct": judge.verdict(checks),
        **out,
        "metrics": metrics,
        "device": dev,
        "checks": {k: {"value": v, "limit": lim}
                   for k, (v, lim) in checks.items() if lim is not None},
    }


def dump(r, path: str) -> None:
    """The run's spans, for measuring the benchmark itself."""
    if isinstance(r, GemmRun):
        data = {"calls": r.calls, "host_s": r.host_s,
                "window": [r.t_window, r.t_end]}
    else:
        t0 = r.t_window
        data = {
            "window": [0.0, r.t_close - t0, r.t_end - t0],
            "reqs": [{"due": q.due, "cls": q.cls, "s": q.prompt_len,
                      "max_new": q.max_new,
                      "prefill": None if q.prefill_start is None
                      else q.prefill_start - t0,
                      "times": [t - t0 for t in q.times],
                      "ok": q.out is not None} for q in r.reqs],
            "steps": [[s.t0 - t0, s.t1 - t0, len(s.rids)] for s in r.steps],
            "prefills": [[p.t0 - t0, p.t1 - t0, p.prompt_len]
                         for p in r.prefills],
        }
    with open(path, "w") as f:
        json.dump(data, f)
