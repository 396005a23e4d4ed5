"""The GEMM stream: one caller in a closed loop issuing ``vortex.ops.gemm``
at row counts the traffic draws, on bf16 operands drawn on the card once.

For each drawn M the seven projections of one layer run in order, each
on the first M rows of a preallocated activation of its input width.
Calls are not synchronized; the window ends with a ``synchronize()``
counted inside it.  The host time of each call (entering
``vortex.ops.gemm`` to its return) is the harness's own span.  The
outputs of a sample of calls drawn from the seed, the largest M among
them, are kept for the comparison after the window.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from kit import program_trace
from kit import traffic as gen
from kit.serving import sync
from kit.trace import Slice, warm_profiler

SAMPLE = 16  # calls compared after the window, besides the largest M


class GemmRun:
    def __init__(self, conf: dict, cell: dict, mix: dict, seed: int,
                 seconds: float, trace: bool, device: str = "cuda",
                 program: bool = False):
        self.conf, self.cell, self.mix = conf, cell, mix
        self.device = device
        self.seed, self.seconds, self.trace_on = seed, seconds, trace
        self.shapes = [tuple(s) for s in mix["shapes"]]
        self.trace = None
        self.calls: list[tuple[int, int]] = []  # (m, shape index)
        self.host_s: list[float] = []
        self.kept: dict[int, torch.Tensor] = {}
        self.slice_calls = (0, 0)
        self.program = program  # the port's tracer on (kit/program_trace)

    def setup(self) -> None:
        from repro_torch import vortex
        from repro_torch.vortex import Engine, EngineConfig

        dev = self.device
        t0 = time.perf_counter()
        gen_ = torch.Generator(device=dev)
        gen_.manual_seed(int(self.seed) % (2 ** 63))
        m_max = self.mix["m_max"]
        self.acts = {}
        for k in sorted({k for k, _ in self.shapes}):
            self.acts[k] = torch.randn((m_max, k), generator=gen_,
                                       dtype=torch.bfloat16, device=dev)
        self.weights = []
        for k, n in self.shapes:
            w = torch.randn((k, n), generator=gen_, dtype=torch.bfloat16,
                            device=dev)
            self.weights.append(w.mul_(k ** -0.5))
        sync(dev)
        t1 = time.perf_counter()
        if self.program:
            program_trace.start()
        self.engine = Engine(EngineConfig(device=dev))
        self.vortex = vortex
        # Every M bucket of every (K, N), at its top and one row under it.
        with vortex.use(self.engine):
            for (k, n), w in zip(self.shapes, self.weights):
                op = vortex.ops.gemm.compile(M=None, N=n, K=k)
                for b in op.buckets(m_max):
                    for m in {b, max(self.mix["m_min"], b - 1)}:
                        m = min(m, m_max)
                        vortex.ops.gemm(self.acts[k][:m], w)
        sync(self.device)
        self.setup_phases = {"operands": t1 - t0,
                             "engine_and_warm": time.perf_counter() - t1}
        if self.trace_on:
            warm_profiler()

    def run(self) -> None:
        rows = gen.gemm_rows(self.mix, 64, self.seed)
        gemm = self.vortex.ops.gemm
        acts, weights, shapes = self.acts, self.weights, self.shapes
        n_shapes = len(shapes)
        # Kept: the seven calls at the first largest M, and a reservoir
        # sample, drawn from the seed, of all the window's calls.
        top = int(np.argmax(rows)) * n_shapes
        top = set(range(top, top + n_shapes))
        pick = random.Random(self.seed + 2)
        sample: dict[int, torch.Tensor] = {}
        calls, host = self.calls, self.host_s
        with self.vortex.use(self.engine):
            t0 = self.t_window = time.perf_counter()
            t_close = self.t_close = t0 + self.seconds
            t_on = t0 + 0.4 * self.seconds
            i = 0
            while True:
                m = int(rows[i % len(rows)])
                i += 1
                for j in range(n_shapes):
                    a = time.perf_counter()
                    out = gemm(acts[shapes[j][0]][:m], weights[j])
                    host.append(time.perf_counter() - a)
                    c = len(calls)
                    calls.append((m, j))
                    if c in top:
                        self.kept[c] = out
                    elif len(sample) < SAMPLE:
                        sample[c] = out
                    elif pick.random() * (c + 1) < SAMPLE:
                        del sample[pick.choice(sorted(sample))]
                        sample[c] = out
                now = time.perf_counter()
                if self.trace_on:
                    if self.trace is None and now >= t_on:
                        self.trace = Slice()
                        self.trace.start()
                        self.slice_calls = (len(calls), len(calls))
                    elif self.trace is not None and not self.trace.stopped \
                            and now >= self.trace.t_started + \
                            self.cell["trace_s"]:
                        self.trace.stop()
                        self.slice_calls = (self.slice_calls[0], len(calls))
                if now >= t_close:
                    break
            sync(self.device)
            self.t_end = time.perf_counter()
        self.kept.update(sample)

    def flops(self) -> float:
        return sum(2.0 * m * self.shapes[j][0] * self.shapes[j][1]
                   for m, j in self.calls)

    def free(self) -> None:
        del self.engine
        if self.device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
