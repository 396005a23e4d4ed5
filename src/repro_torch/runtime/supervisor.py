"""Failure-supervised training loop (a copy of
src/repro/runtime/supervisor.py over the port's CheckpointManager).

The supervisor wraps a step function with checkpoint/restore:

  * every ``ckpt_every`` steps it snapshots (async),
  * on a failure (a real exception, or :class:`SimulatedFailure` injected by
    the tests / chaos hook) it restores the last checkpoint and replays —
    the data pipeline is deterministic in (seed, step), so replay is exact,
  * repeated failures within one step window trip ``max_retries``.

This is the single-process simulation of the multi-host restart protocol;
on a real cluster the same logic runs per-host with the coordinator's
barrier: with several ranks the manager's ``wait`` is that barrier, so
every rank restores the same step.  Restore doubles as the *elastic*
path: ``CheckpointManager.restore`` takes a new mesh's shardings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["SimulatedFailure", "Supervisor"]


class SimulatedFailure(RuntimeError):
    """Injected node failure (chaos testing)."""


@dataclasses.dataclass
class _RunStats:
    steps_run: int = 0
    failures: int = 0
    restores: int = 0


class Supervisor:
    def __init__(
        self,
        ckpt: CheckpointManager,
        *,
        ckpt_every: int = 50,
        max_retries: int = 3,
    ):
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.stats = _RunStats()

    def run(
        self,
        state: Any,
        step_fn: Callable[[Any, int], Any],
        *,
        start_step: int = 0,
        num_steps: int = 100,
        meta: dict | None = None,
        failure_hook: Callable[[int], None] | None = None,
    ) -> Any:
        """Run ``num_steps`` of ``step_fn`` with checkpoint/restart.

        ``step_fn(state, step) -> state``.  ``failure_hook(step)`` may raise
        SimulatedFailure to emulate a node loss at that step boundary.
        """
        step = start_step
        # Resume from the freshest checkpoint if one exists.
        latest = self.ckpt.latest_step()
        if latest is not None and latest > step:
            state = self.ckpt.restore(latest, state)
            step = latest
            self.stats.restores += 1

        retries = 0
        while step < start_step + num_steps:
            try:
                if failure_hook is not None:
                    failure_hook(step)
                state = step_fn(state, step)
                self.stats.steps_run += 1
                step += 1
                retries = 0
                if step % self.ckpt_every == 0:
                    self.ckpt.save_async(step, state, meta)
            except SimulatedFailure:
                self.stats.failures += 1
                retries += 1
                if retries > self.max_retries:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    # No checkpoint yet: replay from the beginning.
                    step = start_step
                else:
                    state = self.ckpt.restore(latest, state)
                    step = latest
                self.stats.restores += 1
        self.ckpt.wait()
        return state
