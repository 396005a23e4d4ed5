"""One tracer for the port: host spans, CUDA-event-timed graph replays and
MoE routing counted on the device.  Off unless :func:`enable` is called.

Hooks follow runtime/faults.py: a module attribute load and, for spans, a
shared no-op context manager while ``ACTIVE`` is None:

    from repro_torch.runtime import trace
    ...
    with trace.span("vx.sched.tick"):
        ...

Each span and counter is there for one per-layer metric (PERF.md §3):

* ``vx.sched.tick`` (``ContinuousScheduler.step``), ``vx.sched.admit``
  (one admission, tagged with its request id), ``vx.sched.readback``
  (the device-to-host read of a step's tokens: waiting, not host work),
  ``vx.serve.prefill`` and ``vx.serve.decode`` (``VortexServer.prefill``
  and ``_decode``): the scheduler's own host time per tick is the tick
  less the parts its server and read-back spans cover;
* ``vx.dispatch`` (``Engine.dispatch``, what ``vortex.ops.<kind>``
  calls) and ``vx.launch`` (each ``entry.run`` in ``VortexKernel.
  _dispatch``, where a full launch queue blocks): a dispatch's own host
  time is its span less its launch;
* replays (``StepGraphs.replay``): a pair of CUDA timing events around
  each graph replay, from a reused pool, tagged with the step's kind and
  the innermost open span.  Pairs resolve lazily, at a later replay when
  the device has passed them, or in :func:`records`; nothing on the hot
  path synchronizes.  On a device with no CUDA events the replay is
  recorded untimed;
* routing (``VortexServer``): per MoE step, the kept expert assignments
  of its real tokens per (MoE layer, expert), written into a
  preallocated device ring (one slot a step, read once by
  :func:`records`), tagged like a replay.

Spans run on the host's clock (``time.perf_counter_ns``).  While a
``torch.profiler`` session runs each span also opens a ``record_function``
range of its name, so a profiler trace shows it beside the kernels.  No
span sits inside code a CUDA graph captures: host code runs once, at the
capture.  Records go into memory, at most ``CAPACITY`` spans (later ones
are counted in ``spans_dropped``) and ``RING`` routing slots (older ones
are overwritten and counted in ``routing_dropped``); :func:`records` is
the only way out.
"""
from __future__ import annotations

import collections
import threading
import time

import torch

__all__ = ["ACTIVE", "CAPACITY", "NOOP", "RING", "Tracer", "disable",
           "enable", "records", "span"]

CAPACITY = 1 << 20  # span records kept
RING = 8192  # routing slots on the device


class _Noop:
    """The one context manager every span is while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


def _event_pair(device: torch.device):
    """Two timing events for a replay on ``device``; None where the device
    has no CUDA events."""
    if device.type != "cuda":
        return None
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


class _Span:
    """An open span: ``rec`` is ``[name, t0_ns, t1_ns, parent record,
    rid]``."""

    __slots__ = ("tracer", "rec", "rf")

    def __init__(self, tracer: "Tracer", name: str, rid):
        self.tracer = tracer
        self.rec = [name, 0, 0, None, rid]
        self.rf = None

    def __enter__(self):
        stack = self.tracer._stack()
        if stack:
            self.rec[3] = stack[-1]
        stack.append(self.rec)
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.rec[0])
            self.rf.__enter__()
        self.rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.tracer._stack().pop()
        return False


class Tracer:
    """The records of one enabled period (module docstring)."""

    def __init__(self) -> None:
        self.spans: list[list] = []
        self.spans_dropped = 0
        # Replays: [kind, span record, device ms or None, event pair].
        self.replays: list[list] = []
        self._pending: collections.deque = collections.deque()
        self._pool: list[tuple] = []
        # Routing: [kind, span record, sequence number]; the ring holds
        # the last RING sequence numbers' counts.
        self.routing: list[list] = []
        self._ring: torch.Tensor | None = None
        self._routed = 0
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _innermost(self):
        st = self._stack()
        return st[-1] if st else None

    def span(self, name: str, rid=None):
        if len(self.spans) >= CAPACITY:
            self.spans_dropped += 1
            return NOOP
        s = _Span(self, name, rid)
        self.spans.append(s.rec)
        return s

    # -- replays ----------------------------------------------------------

    def replay_begin(self, kind: str, device: torch.device) -> list:
        """Open a replay record; the caller replays, then calls
        :meth:`replay_end` with it."""
        self._resolve(block=False)
        pair = self._pool.pop() if self._pool else _event_pair(device)
        if pair is not None:
            pair[0].record()
        rec = [kind, self._innermost(), None, pair]
        self.replays.append(rec)
        return rec

    def replay_end(self, rec: list) -> None:
        pair = rec[3]
        if pair is not None:
            pair[1].record()
            self._pending.append(rec)

    def _resolve(self, block: bool) -> None:
        """Read the pairs the device has passed (all of them, waiting,
        with ``block``) and return their events to the pool."""
        while self._pending:
            rec = self._pending[0]
            start, end = rec[3]
            if block:
                end.synchronize()
            elif not end.query():
                return
            self._pending.popleft()
            rec[2] = start.elapsed_time(end)
            rec[3] = None
            self._pool.append((start, end))

    # -- routing ----------------------------------------------------------

    def routed(self, kind: str, counts: torch.Tensor) -> None:
        """File one step's (MoE layers, experts) kept-assignment counts
        into the next ring slot (a device copy; nothing is read)."""
        ring = self._ring
        if ring is None or ring.shape[1:] != counts.shape \
                or ring.device != counts.device:
            if ring is not None:
                # A model of other widths: the old counts are unreadable.
                for rec in self.routing:
                    rec[2] = -1
            ring = self._ring = torch.zeros(
                (RING, *counts.shape), dtype=torch.int32,
                device=counts.device)
        n = self._routed
        self._routed += 1
        ring[n % RING].copy_(counts)
        self.routing.append([kind, self._innermost(), n])

    # -- the way out ------------------------------------------------------

    def records(self) -> dict:
        """Every record as plain data (synchronizes once for the pending
        replays and reads the routing ring once):

        * ``spans``: ``(name, t0_ns, t1_ns, parent index or -1, rid)``;
        * ``replays``: ``(kind, span index or -1, device ms or None)``;
        * ``routing``: ``(kind, span index or -1, (layers, experts) int
          array)`` for the slots still in the ring;
        * ``spans_dropped``, ``routing_dropped``: what ``CAPACITY`` and
          ``RING`` left out.
        """
        self._resolve(block=True)
        index = {id(r): i for i, r in enumerate(self.spans)}

        def at(rec) -> int:
            return -1 if rec is None else index.get(id(rec), -1)

        spans = [(r[0], r[1], r[2], at(r[3]), r[4]) for r in self.spans]
        replays = [(r[0], at(r[1]), r[2]) for r in self.replays]
        ring = self._ring.cpu().numpy() if self._ring is not None else None
        oldest = self._routed - RING
        routing = [(r[0], at(r[1]), ring[r[2] % RING])
                   for r in self.routing if r[2] >= 0 and r[2] >= oldest]
        return {"spans": spans, "replays": replays, "routing": routing,
                "spans_dropped": self.spans_dropped,
                "routing_dropped": len(self.routing) - len(routing)}


# The enabled tracer; None (the default) turns every hook into one
# attribute check.
ACTIVE: Tracer | None = None


def enable() -> Tracer:
    """Start recording into a fresh tracer."""
    global ACTIVE
    ACTIVE = Tracer()
    return ACTIVE


def disable() -> None:
    """Stop recording; the records go with the tracer."""
    global ACTIVE
    ACTIVE = None


def span(name: str, rid=None):
    """A span of ``name`` (and request id ``rid``) over a ``with`` block;
    the shared :data:`NOOP` while the tracer is off."""
    tr = ACTIVE
    return NOOP if tr is None else tr.span(name, rid)


def records() -> dict | None:
    """The enabled tracer's records (:meth:`Tracer.records`); None while
    off."""
    tr = ACTIVE
    return None if tr is None else tr.records()
