"""The server's steps as CUDA graphs: one captured decode step per (form,
batch bucket, kv bucket, cache) and one captured prefill per (batch
bucket, seq bucket, cache) -- the counterparts of the reference's AOT
decode programs (``_decode_exec_for`` / ``_decode_exec_vec_for``) and AOT
prefill programs (``_prefill_exec_for``, src/repro/launch/serve.py).

A :class:`StepGraphs` keeps an LRU of :class:`StepGraph` entries for one
kind of step.  :class:`DecodeGraphs` keys ``(form, bp, kvb, leaf
addresses)``: ``form`` is ``"scalar"`` (one ``pos`` for the batch,
``generate()``) or ``"vector"`` (a (bp,) ``pos``, the scheduler's step).
:class:`PrefillGraphs` keys ``(bp, sp, leaf addresses)``; its static
inputs are the (bp, sp) tokens and the (1,) index of the last real prompt
token, its static outputs the first-token logits and the MoE
``dropped_frac``.  The addresses are the ``data_ptr()`` of every cache
leaf the graph binds, so a replay never runs against a cache other than
the one it captured: a cache at new addresses captures anew.  The two
kinds keep separate LRUs (a burst of prompts cannot evict the decode
graphs) and draw from one memory pool (:class:`GraphMemory`: graphs
replay in sequence on one stream, never concurrently).

Capturing a key first runs the step once eagerly on the capture stream
(which builds the engine's executables and selections and allocates the
kernels' per-stream scratch and staging sets outside the capture), then
captures it.  Both steps are idempotent -- a decode step writes the same
k/v (ckv/k_rope) row at the same ``pos``, a prefill the same cache rows,
the whole Mamba state and the whole ``encoder_out`` (which decode steps
only read, at the address the graph binds) -- so the warm-up leaves the
cache as the replay that follows it does.  A Mamba decode step is not: it advances the
``conv``/``ssm`` state it reads.  Those leaves (``state``) are copied
before the warm-up and put back after it and after the capture, so the
replay that follows advances them once, as one eager step does.  The host
counters the warm-up and the capture advanced (the engine's DispatchStats,
the kernels' launch counters) are rolled back, and each replay adds the
delta one captured step counted: the counters read as an eager run's.
The staging-buffer sets the capture bound stay referenced by the graph, so
the engine's pool evicting them never frees memory a replay writes.

The engine's degradation ladder (core/engine.py ``_degrade``) may fire
inside a warm-up or a capture.  Its events (``quarantined``,
``fallbacks``) change what the engine serves, not what one step counts:
they stay counted once, outside the rollback and outside a replay's
delta, as a quarantine during the reference's AOT trace counts once and
never per program call.  A capture in which the ladder fired is dropped
(it holds a failed rung's staging copy and an unsettled selection) and
the key is warmed up and captured once more, by when the ladder has
settled on a healthy candidate; a second unsettled capture raises.  A
replay is not an engine launch, so it fires no fault site.  A quarantine
drops no graph: a captured graph has launched its candidates on this
card, as the reference's AOT programs keep what they traced.

Nothing else falls back: a capture or replay that fails raises.
:func:`capture_graph` is the one call that needs the card; the CPU tests
replace it with a stub.

While the tracer is on (runtime/trace.py) each replay is recorded with
its kind (``StepGraphs.KIND``) and, on the card, timed by a pair of CUDA
events around it; while it is off a replay pays one attribute check.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable

import torch

from repro_torch import kernels
from repro_torch.runtime import trace

__all__ = ["DecodeGraphs", "GraphMemory", "PrefillGraphs", "StepCounters",
           "StepGraph", "StepGraphs", "capture_graph"]


# DispatchStats fields the degradation ladder moves: events of the engine,
# not counts of a step (module docstring).
LADDER_FIELDS = ("quarantined", "fallbacks")


class StepCounters:
    """The host counters a step advances: every engine kernel's
    DispatchStats and the hand-written kernels' launch counters."""

    def __init__(self, engine):
        self.engine = engine

    def read(self) -> tuple[dict, dict]:
        return (
            {sig: k.dispatch_stats.as_dict()
             for sig, k in self.engine.kernels().items()},
            kernels.launch_counts(),
        )

    @staticmethod
    def diff(before: tuple, after: tuple) -> tuple[dict, dict]:
        """``after - before``, leaving out what did not move."""
        (d0, l0), (d1, l1) = before, after
        disp = {}
        for sig, fields in d1.items():
            old = d0.get(sig, {})
            moved = {f: n - old.get(f, 0) for f, n in fields.items()
                     if n != old.get(f, 0)}
            if moved:
                disp[sig] = moved
        return disp, {k: n - l0[k] for k, n in l1.items() if n != l0[k]}

    @staticmethod
    def ladder_moved(delta: tuple) -> bool:
        """True if ``delta`` holds a degradation-ladder event."""
        return any(f in LADDER_FIELDS
                   for fields in delta[0].values() for f in fields)

    @staticmethod
    def without_ladder(delta: tuple) -> tuple:
        """``delta`` less its degradation-ladder fields."""
        disp, launches = delta
        return ({sig: {f: n for f, n in fields.items()
                       if f not in LADDER_FIELDS}
                 for sig, fields in disp.items()}, launches)

    def add(self, delta: tuple, sign: int = 1) -> None:
        disp, launches = delta
        kerns = self.engine.kernels()
        for sig, fields in disp.items():
            kerns[sig].add_dispatch_stats(
                {f: sign * n for f, n in fields.items()})
        kernels.add_launch_counts({k: sign * n for k, n in launches.items()})


def capture_graph(fn: Callable, pool, stream):
    """Capture ``fn()`` into a CUDA graph on ``stream`` from ``pool``;
    returns ``(graph, what fn returned)`` -- its tensors are the graph's
    static outputs, rewritten by every replay."""
    if stream is None:
        raise RuntimeError("a step is captured on the card only")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        out = fn()
    return graph, out


@contextlib.contextmanager
def _on_stream(stream):
    """Run the body on ``stream`` (None: the CPU, no stream), ordered after
    the caller's stream's pending work and before its later work."""
    if stream is None:
        yield
        return
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        yield
    cur.wait_stream(stream)


class GraphMemory:
    """The capture stream and the one memory pool every graph of a server
    draws from, made at the first capture on the card (None on the CPU)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = None
        self.pool = None

    def ready(self) -> tuple:
        if self.device.type == "cuda" and self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()
        return self.stream, self.pool


@dataclasses.dataclass
class StepGraph:
    """One captured step: its static inputs, which the caller fills before
    a replay, its static outputs, the counters one step advances, and what
    it must keep alive."""

    graph: object
    inputs: tuple
    outputs: tuple
    delta: tuple
    keepalive: list


class StepGraphs:
    """An LRU of captured steps of one kind, at most ``MAX_GRAPHS``.

    ``step(*inputs)`` is the eager step against the key's cache (it closes
    over the cache), returning the tuple of tensors a replay hands back.
    A subclass names the static inputs: ``_statics(*values)`` makes them
    on the device, ``_fill(inputs, *values)`` refills them, and its
    ``KIND``.
    """

    MAX_GRAPHS = 32
    KIND: str  # the replay records' kind (runtime/trace.py)

    def __init__(self, engine, device: torch.device,
                 memory: GraphMemory | None = None):
        self.engine = engine
        self.device = device
        self.memory = memory if memory is not None else GraphMemory(device)
        self.counters = StepCounters(engine)
        self._graphs: collections.OrderedDict[tuple, StepGraph] = \
            collections.OrderedDict()

    def keys(self) -> list[tuple]:
        return list(self._graphs)

    def get(self, key: tuple) -> StepGraph | None:
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
        return g

    def _statics(self, *values) -> tuple:
        raise NotImplementedError

    @staticmethod
    def _fill(inputs: tuple, *values) -> None:
        raise NotImplementedError

    def capture(self, key: tuple, step: Callable, *values,
                state=()) -> StepGraph:
        """Warm up and capture ``step`` for ``key`` with static inputs
        holding ``values``; the counters end as they began, and so do the
        tensors in ``state`` (ones the step updates from their own
        contents)."""
        stream, pool = self.memory.ready()
        inputs = self._statics(*values)
        # A calibration slice on another thread (CalibrationDaemon) would
        # synchronize the card mid-capture and move the counters rolled
        # back below: the capture holds the calibrator's lock.
        cal = getattr(self.engine, "calibrator", None)
        with cal.lock if cal is not None else contextlib.nullcontext():
            return self._capture(key, step, inputs, stream, pool, state)

    def _capture(self, key, step, inputs, stream, pool,
                 state) -> StepGraph:
        before = self.counters.read()
        try:
            with _on_stream(stream):
                saved = [t.clone() for t in state]

                def restore():
                    for t, s in zip(state, saved):
                        t.copy_(s)

                for _ in range(2):
                    step(*inputs)  # warm-up: executables, scratch, staging
                    restore()
                    warm = self.counters.read()
                    graph, outputs = capture_graph(
                        lambda: step(*inputs), pool, stream)
                    restore()
                    delta = StepCounters.diff(warm, self.counters.read())
                    if not StepCounters.ladder_moved(delta):
                        break
                    del graph, outputs  # the ladder fired: capture again
                else:
                    raise RuntimeError(
                        "the degradation ladder fired in two captures of "
                        "one step: no settled candidate to capture")
        finally:
            self.counters.add(StepCounters.without_ladder(StepCounters.diff(
                before, self.counters.read())), sign=-1)
        keepalive = [s for k in self.engine.kernels().values()
                     for s in k.staging_sets()]
        g = StepGraph(graph, inputs, tuple(outputs), delta, keepalive)
        self._graphs[key] = g
        while len(self._graphs) > self.MAX_GRAPHS:
            self._graphs.popitem(last=False)
        return g

    def replay(self, g: StepGraph, *values) -> tuple:
        """Fill the static inputs, replay, count one step; the static
        outputs (callers copy what they hand on)."""
        self._fill(g.inputs, *values)
        tr = trace.ACTIVE
        if tr is None:
            g.graph.replay()
        else:
            rec = tr.replay_begin(self.KIND, self.device)
            g.graph.replay()
            tr.replay_end(rec)
        self.counters.add(g.delta)
        return g.outputs


class DecodeGraphs(StepGraphs):
    """Decode steps: static inputs ``tokens`` (bp, 1) and ``pos`` (bp,)
    int32 (an int ``pos`` fills the vector)."""

    KIND = "decode"

    def _statics(self, tokens, pos) -> tuple:
        inputs = (tokens.to(self.device).clone(),
                  torch.empty(tokens.shape[0], dtype=torch.int32,
                              device=self.device))
        self._fill(inputs, tokens, pos)
        return inputs

    @staticmethod
    def _fill(inputs, tokens, pos) -> None:
        st_tokens, st_pos = inputs
        st_tokens.copy_(tokens)
        if torch.is_tensor(pos):
            st_pos.copy_(pos)
        else:
            st_pos.fill_(pos)


class PrefillGraphs(StepGraphs):
    """Prefills: static inputs ``tokens`` (bp, sp) int64 and ``last`` (1,)
    int64, the index of the last real prompt token.  Fewer entries than
    the decode LRU: each holds its bucket's cache binding and static
    logits."""

    MAX_GRAPHS = 16
    KIND = "prefill"

    def _statics(self, tokens, last) -> tuple:
        inputs = (torch.empty(tuple(tokens.shape), dtype=torch.long,
                              device=self.device),
                  torch.empty((1,), dtype=torch.long, device=self.device))
        self._fill(inputs, tokens, last)
        return inputs

    @staticmethod
    def _fill(inputs, tokens, last) -> None:
        st_tokens, st_last = inputs
        st_tokens.copy_(tokens)
        st_last.fill_(last)
