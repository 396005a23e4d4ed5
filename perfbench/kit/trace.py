"""A traced slice of the window: ``torch.profiler`` over whole scheduler
iterations (or whole calls), read back as the device's kernel intervals.

The slice is marked by a ``pb.slice`` range on the host, so its start
and length come from the trace's own clock.  Device activity is every
kernel, copy and fill the trace holds inside it; busy time is the union
of their intervals.  Idle gaps are named by the innermost host range
(harness span, aten op or runtime call) open at the gap's midpoint.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime")
SLICE = "pb.slice"


class Slice:
    """Start and stop a traced slice; :meth:`read` parses it once."""

    def __init__(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._range = None
        self.stopped = False

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof.start()
        self._range = torch.profiler.record_function(SLICE)
        self._range.__enter__()
        # Starting the profiler can take seconds: the slice's length
        # counts from here.
        self.t_started = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t_stopped = time.perf_counter()
        self._range.__exit__(None, None, None)
        self._prof.stop()
        self.stopped = True

    def read(self) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return Trace(events)


def _short(name: str) -> str:
    """A kernel's name without its return type and its argument list (the
    last top-level parenthesized group)."""
    name = re.sub(r"^void ", "", name)
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:160]


def warm_profiler() -> None:
    """Start and stop the profiler once on a trivial op, so its first
    start (CUPTI's set-up, seconds) falls into set-up, not the window."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Trace:
    """The device intervals and host ranges inside the ``pb.slice`` range
    (times in microseconds on the trace's clock)."""

    def __init__(self, events: list[dict]) -> None:
        slices = [e for e in events if e.get("name") == SLICE
                  and e.get("cat") == "user_annotation"]
        if not slices:
            raise RuntimeError("the trace holds no pb.slice range")
        s = slices[0]
        self.t0 = float(s["ts"])
        self.t1 = self.t0 + float(s["dur"])
        self.window_us = self.t1 - self.t0
        self.device = []  # (start, end, short name, category)
        self.host = []  # (start, end, name)
        for e in events:
            cat = e.get("cat")
            if "dur" not in e or "ts" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b <= self.t0 or a >= self.t1:
                continue
            if cat in DEVICE_CATS:
                self.device.append((max(a, self.t0), min(b, self.t1),
                                    _short(e["name"]), cat))
            elif cat in HOST_CATS and e["name"] != SLICE:
                self.host.append((a, b, e["name"]))
        self.device.sort()
        self._busy = self._union()

    def _union(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for a, b, _, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_us(self) -> float:
        return sum(b - a for a, b in self._busy)

    def kernel_us(self, pattern: str) -> tuple[float, int, list[str]]:
        """Summed device time and count of the kernels whose short name
        matches ``pattern`` (a regular expression), and the names
        matched."""
        rx = re.compile(pattern)
        total, n, names = 0.0, 0, set()
        for a, b, name, cat in self.device:
            if cat == "kernel" and rx.search(name):
                total += b - a
                n += 1
                names.add(name)
        return total, n, sorted(names)

    def top_ops(self, k: int = 10) -> list[list]:
        agg: dict[str, float] = {}
        for a, b, name, _ in self.device:
            agg[name] = agg.get(name, 0.0) + (b - a)
        top = sorted(agg.items(), key=lambda kv: -kv[1])[:k]
        return [[name, us * 1e-6] for name, us in top]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The ``k`` longest gaps with no device activity, each named by
        the innermost host range open at its midpoint."""
        edges = [self.t0]
        for a, b in self._busy:
            edges += [a, b]
        edges.append(self.t1)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) / 2
            open_ = [h for h in self.host if h[0] <= mid <= h[1]]
            name = (min(open_, key=lambda h: h[1] - h[0])[2]
                    if open_ else "host: no range open")
            out.append([name, (b - a) * 1e-6])
        return out
