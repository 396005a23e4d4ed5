"""Phase-robust wall-clock timing: interleaved adaptive min-vs-min
(counterpart of src/repro/core/timing.py).

Shared hosts throttle in long (~0.5-1.5 s) phases during which even
identical computations run 2x slower, and the phase can anti-correlate with
a naive A/B alternation, so a mean or median of either side is phase
lottery.  Three defences:

  * INTERLEAVED short windows: every round times each variant back to
    back, so a throttling phase inflates all variants in the same round;
  * MIN-VS-MIN with adaptive stop: sampling continues until every
    variant's minimum has stopped improving for ``patience`` rounds, and
    only the minima are compared;
  * RETRY KEEPING BEST (:func:`retry_best`): throttling can only inflate a
    window, so re-measuring and keeping the best attempt estimates the true
    cost, while a real regression fails every attempt.

Each timed window is host wall-clock around calls that each end in a
``torch.cuda.synchronize`` of the output's device (nothing to wait for on
the CPU), so a window holds host staging plus device time — what the
hot-path gate compares.  All timings are seconds; per-round samples are
kept in microseconds (rounded to ns) so a flaky gate can be diagnosed from
the committed JSON.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import torch

__all__ = ["MinTimings", "interleaved_minima", "retry_best", "synchronize"]


def synchronize(out: object) -> object:
    """Wait for ``out``: synchronize the CUDA device of the first tensor in
    it (a tensor, or a tuple/list/dict holding tensors); nothing on the
    CPU.  Returns ``out``."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
            return out
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    return out


@dataclasses.dataclass(frozen=True)
class MinTimings:
    """Result of one :func:`interleaved_minima` measurement.

    ``best_s[i]`` is variant ``i``'s best per-call seconds across all
    rounds; ``samples_us[i]`` its raw per-round means (microseconds,
    rounded to ns precision) in measurement order.  ``rounds`` is how many
    rounds ran before the adaptive stop.
    """

    best_s: tuple[float, ...]
    samples_us: tuple[tuple[float, ...], ...]
    rounds: int

    def ratio(self, i: int, j: int) -> float:
        """best_s[i] / best_s[j] (guarded against a zero denominator)."""
        return self.best_s[i] / max(self.best_s[j], 1e-12)


def interleaved_minima(
    calls: Sequence[Callable[[], object]],
    *,
    inner: int = 2,
    min_rounds: int = 20,
    max_rounds: int = 80,
    patience: int = 10,
    improvement: float = 0.99,
    warmup: bool = True,
    deadline_s: float | None = None,
) -> MinTimings:
    """Phase-robust minima for N variants, interleaved per round.

    Each round times ``inner`` back-to-back calls of every variant (each
    call synchronized).  A round that improves ANY variant's minimum by
    more than ``1 - improvement`` resets the staleness counter; the loop
    stops once at least ``min_rounds`` ran and no minimum improved for
    ``patience`` consecutive rounds (or at ``max_rounds``/``deadline_s``,
    whichever first).  ``warmup`` runs one untimed call per variant first,
    so a kernel library's first build (nvcc) and buffer allocation never
    land inside a timed window.
    """
    if not calls:
        raise ValueError("need at least one variant to time")
    if warmup:
        for fn in calls:
            synchronize(fn())
    n = len(calls)
    best = [float("inf")] * n
    samples: list[list[float]] = [[] for _ in range(n)]
    stale = 0
    rounds = 0
    t_start = time.perf_counter()
    for r in range(max_rounds):
        improved = False
        for i, fn in enumerate(calls):
            t0 = time.perf_counter()
            for _ in range(inner):
                synchronize(fn())
            t = (time.perf_counter() - t0) / inner
            samples[i].append(round(t * 1e6, 3))
            if t < best[i] * improvement:
                improved = True
            best[i] = min(best[i], t)
        rounds = r + 1
        stale = 0 if improved else stale + 1
        if rounds >= min_rounds and stale >= patience:
            break
        if (
            deadline_s is not None
            and time.perf_counter() - t_start >= deadline_s
            and all(b != float("inf") for b in best)
        ):
            break
    return MinTimings(
        best_s=tuple(best),
        samples_us=tuple(tuple(s) for s in samples),
        rounds=rounds,
    )


def retry_best(
    measure: Callable[[], object],
    *,
    attempts: int = 4,
    accept: Callable[[object], bool],
    key: Callable[[object], float],
    stats: dict | None = None,
):
    """Re-run ``measure`` until ``accept`` holds or ``attempts`` exhaust,
    keeping the attempt with the smallest ``key``.

    When ``stats`` is given, it records the retry telemetry for the bench
    JSON: ``attempts`` (measurements actually run) and ``accepted``
    (whether the kept attempt satisfied ``accept``).
    """
    best = measure()
    used = 1
    for _ in range(max(attempts, 1) - 1):
        if accept(best):
            break
        cur = measure()
        used += 1
        if key(cur) < key(best):
            best = cur
    if stats is not None:
        stats["attempts"] = used
        stats["accepted"] = bool(accept(best))
    return best
