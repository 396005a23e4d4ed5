"""The port's own spans and counters (``repro_torch.runtime.trace``) for
the per-layer readers that read them.

A reader declares that it reads them: its module under
``perfbench/metrics/`` sets ``PROGRAM_TRACE = True``
(:func:`kit.spec.wants_program`).  Only where a traced run (``--trace
1``) has such a reader does set-up turn the port's tracer on
(:func:`start`), before the server or the engine is built; a run whose
readers declare nothing runs as if this module were not there.  After
the window :func:`read` takes the records once and hands readers, as
``ctx.program``, those of the window and those of the traced slice, on
the harness's clock (``time.perf_counter()`` seconds).
"""
from __future__ import annotations

import dataclasses


def start() -> None:
    """Turn the port's tracer on."""
    from repro_torch.runtime import trace

    trace.enable()


@dataclasses.dataclass
class Records:
    """The tracer's records (``trace.records()``) with span times in
    seconds: ``spans`` (name, t0, t1, parent index or -1, rid),
    ``replays`` (kind, span index or -1, device ms or None), ``routing``
    (kind, span index or -1, (MoE layers, experts) counts), and what the
    tracer's bounds left out."""

    spans: list
    replays: list
    routing: list
    spans_dropped: int
    routing_dropped: int

    def between(self, t0: float, t1: float) -> "Records":
        """The spans that start in [t0, t1), and the replays and routing
        counts taken inside them (indices renumbered; a parent outside
        becomes -1)."""
        keep = [i for i, s in enumerate(self.spans) if t0 <= s[1] < t1]
        new = {old: i for i, old in enumerate(keep)}
        spans = [(n, a, b, new.get(p, -1), rid)
                 for n, a, b, p, rid in (self.spans[i] for i in keep)]
        return Records(
            spans=spans,
            replays=[(k, new[s], ms) for k, s, ms in self.replays
                     if s in new],
            routing=[(k, new[s], c) for k, s, c in self.routing if s in new],
            spans_dropped=self.spans_dropped,
            routing_dropped=self.routing_dropped)


@dataclasses.dataclass
class ProgramTrace:
    """What a reader sees: the records of the ``window`` and those of the
    traced ``slice`` (None without one)."""

    window: Records
    slice: Records | None


def read(run) -> ProgramTrace | None:
    """The run's records, read once and the tracer turned off; None
    where the run did not ask for them."""
    if not run.program:
        return None
    from repro_torch.runtime import trace

    raw = trace.records()
    trace.disable()
    recs = Records(
        spans=[(n, a * 1e-9, b * 1e-9, p, rid)
               for n, a, b, p, rid in raw["spans"]],
        replays=list(raw["replays"]), routing=list(raw["routing"]),
        spans_dropped=raw["spans_dropped"],
        routing_dropped=raw["routing_dropped"])
    sl = run.trace
    return ProgramTrace(
        window=recs.between(run.t_window, run.t_close),
        slice=None if sl is None else recs.between(sl.t_started,
                                                   sl.t_stopped))
