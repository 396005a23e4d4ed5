"""One captured decode step per (form, batch bucket, kv bucket, cache): the
CUDA-graph counterpart of the reference's AOT decode programs
(``_decode_exec_for`` / ``_decode_exec_vec_for``, src/repro/launch/
serve.py).

A :class:`DecodeGraphs` keeps an LRU of :class:`DecodeGraph` entries.  A
key is ``(form, bp, kvb, leaf addresses)``: ``form`` is ``"scalar"`` (one
``pos`` for the batch, ``generate()``) or ``"vector"`` (a (bp,) ``pos``,
the scheduler's step), and the addresses are the ``data_ptr()`` of every
cache leaf the graph binds, so a replay never runs against a cache other
than the one it captured: a cache at new addresses captures anew.  Every
graph draws from one memory pool (graphs replay in sequence on one
stream, never concurrently).

Capturing a key first runs the step once eagerly on the capture stream
(which builds the engine's executables and selections and allocates the
kernels' per-stream scratch outside the capture), then captures it.  The
step is idempotent -- it writes the same k/v row at the same ``pos`` --
so the warm-up leaves the cache as the replay that follows it does.  The
host counters the warm-up and the capture advanced (the engine's
DispatchStats, the kernels' launch counters) are rolled back, and each
replay adds the delta one captured step counted: the counters read as an
eager run's.  The staging-buffer sets the capture bound stay referenced by
the graph, so the engine's pool evicting them never frees memory a replay
writes.

Nothing falls back: a capture or replay that fails raises.
:func:`capture_graph` is the one call that needs the card; the CPU tests
replace it with a stub.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable

import torch

from repro_torch import kernels

__all__ = ["DecodeGraph", "DecodeGraphs", "StepCounters", "capture_graph"]


class StepCounters:
    """The host counters a decode step advances: every engine kernel's
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
        raise RuntimeError("a decode step is captured on the card only")
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


@dataclasses.dataclass
class DecodeGraph:
    """One captured decode step: its static inputs, which the caller fills
    before a replay (``tokens`` (bp, 1), ``pos`` (bp,) int32), its static
    outputs, the counters one step advances, and what it must keep alive."""

    graph: object
    tokens: torch.Tensor
    pos: torch.Tensor
    outputs: tuple
    delta: tuple
    keepalive: list


class DecodeGraphs:
    """An LRU of captured decode steps, at most ``MAX_GRAPHS`` of them.

    ``step(tokens, pos)`` is the eager decode step against the key's cache
    (it closes over the cache), returning the tuple of tensors a replay
    hands back.
    """

    MAX_GRAPHS = 32

    def __init__(self, engine, device: torch.device):
        self.engine = engine
        self.device = device
        self.counters = StepCounters(engine)
        self._graphs: collections.OrderedDict[tuple, DecodeGraph] = \
            collections.OrderedDict()
        self._pool = None
        self._stream = None

    def keys(self) -> list[tuple]:
        return list(self._graphs)

    def get(self, key: tuple) -> DecodeGraph | None:
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
        return g

    def capture(self, key: tuple, step: Callable, tokens: torch.Tensor,
                pos) -> DecodeGraph:
        """Warm up and capture ``step`` for ``key`` with static inputs
        holding ``tokens`` and ``pos`` (an int fills the (bp,) vector);
        the counters end as they began."""
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        st_tokens = tokens.to(self.device).clone()
        st_pos = torch.empty(tokens.shape[0], dtype=torch.int32,
                             device=self.device)
        self._fill(st_tokens, st_pos, tokens, pos)
        # A calibration slice on another thread (CalibrationDaemon) would
        # synchronize the card mid-capture and move the counters rolled
        # back below: the capture holds the calibrator's lock.
        cal = getattr(self.engine, "calibrator", None)
        with cal.lock if cal is not None else contextlib.nullcontext():
            return self._capture(key, step, st_tokens, st_pos)

    def _capture(self, key, step, st_tokens, st_pos) -> DecodeGraph:
        before = self.counters.read()
        try:
            with _on_stream(self._stream):
                step(st_tokens, st_pos)  # warm-up: executables, scratch
                warm = self.counters.read()
                graph, outputs = capture_graph(
                    lambda: step(st_tokens, st_pos), self._pool,
                    self._stream)
            after = self.counters.read()
        finally:
            self.counters.add(
                StepCounters.diff(before, self.counters.read()), sign=-1)
        keepalive = [s for k in self.engine.kernels().values()
                     for s in k.staging_sets()]
        g = DecodeGraph(graph, st_tokens, st_pos, tuple(outputs),
                        StepCounters.diff(warm, after), keepalive)
        self._graphs[key] = g
        while len(self._graphs) > self.MAX_GRAPHS:
            self._graphs.popitem(last=False)
        return g

    @staticmethod
    def _fill(st_tokens, st_pos, tokens, pos) -> None:
        st_tokens.copy_(tokens)
        if torch.is_tensor(pos):
            st_pos.copy_(pos)
        else:
            st_pos.fill_(pos)

    def replay(self, g: DecodeGraph, tokens: torch.Tensor, pos) -> tuple:
        """Fill the static inputs, replay, count one step; the static
        outputs (callers copy what they hand on)."""
        self._fill(g.tokens, g.pos, tokens, pos)
        g.graph.replay()
        self.counters.add(g.delta)
        return g.outputs
