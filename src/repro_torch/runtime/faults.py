"""Deterministic fault injection for chaos tests (a copy of
src/repro/runtime/faults.py; DESIGN.md §11).

The six sites are the reference's, and this package threads all of them:
``precompile`` (``VortexKernel._build_executable``) and ``aot_launch``
(``_CacheEntry.run``, core/engine.py), ``pool_lease``
(``KVBucketPool.lease``, launch/serve.py), ``scheduler_step``
(``ContinuousScheduler`` admit and decode launch, launch/scheduler.py),
``cache_io`` (``Calibrator.save``/``load``, ``DenylistStore`` I/O) and
``calib_measure`` (``Calibrator._measure_bucket``, core/calibrate.py).
A CUDA graph's replay is not an ``_CacheEntry.run`` and fires no site, as
the reference's traced AOT programs fire none.

A :class:`FaultPlan` names *sites* (fixed hook points threaded through the
engine, server, scheduler and calibrator) and the exact 1-based occurrence
indices at which each site must fail.  Hooks are two lines and free when no
plan is installed — a module attribute load plus an ``is None`` check:

    from repro_torch.runtime import faults
    ...
    if faults.ACTIVE is not None:
        faults.ACTIVE.check("pool_lease")

Plans are exact ("fail the 3rd lease"), so a chaos run is reproducible from
its seed alone: the same plan against the same code fails the same calls.
Occurrence counters are per-site and thread-safe; ``fired`` records every
injection in order for post-hoc assertions.  Install scoped via
:func:`installed` so a crashed test never leaks a plan into the next one.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterable, Mapping

__all__ = [
    "ACTIVE",
    "PENDING",
    "SITES",
    "THREADED",
    "FaultPlan",
    "InjectedFault",
    "installed",
]

# Every named hook point in the codebase.  Keep in sync with DESIGN.md §11.
SITES = (
    "precompile",      # VortexKernel._build_executable (core/engine.py)
    "aot_launch",      # _CacheEntry.run (core/engine.py)
    "pool_lease",      # KVBucketPool.lease (launch/serve.py)
    "cache_io",        # Calibrator save/load, DenylistStore I/O
    "calib_measure",   # Calibrator._measure_bucket (core/calibrate.py)
    "scheduler_step",  # ContinuousScheduler admit + decode launch
)
# Sites no hook of this package checks: none.  THREADED are the others.
PENDING: tuple[str, ...] = ()
THREADED = tuple(s for s in SITES if s not in PENDING)


class InjectedFault(RuntimeError):
    """Raised by a hook when its occurrence index is in the plan."""

    def __init__(self, site: str, occurrence: int):
        self.site = site
        self.occurrence = occurrence
        super().__init__(
            f"injected fault at site {site!r} (occurrence {occurrence})"
        )


class FaultPlan:
    """Site -> set of 1-based occurrence indices that must fail."""

    def __init__(self, spec: Mapping[str, Iterable[int]]):
        for site in spec:
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; known: {SITES}"
                )
        self.spec: dict[str, frozenset[int]] = {
            site: frozenset(int(n) for n in occs)
            for site, occs in spec.items()
        }
        if any(n < 1 for occs in self.spec.values() for n in occs):
            raise ValueError("occurrence indices are 1-based")
        self._lock = threading.Lock()
        self._seen: dict[str, int] = {}
        self.fired: list[tuple[str, int]] = []

    @classmethod
    def random(
        cls,
        seed: int,
        *,
        sites: Iterable[str] = SITES,
        rate: float = 0.05,
        horizon: int = 100,
    ) -> "FaultPlan":
        """Seeded random plan: each of the first ``horizon`` occurrences of
        each site fails independently with probability ``rate``.  If the
        draw selects nothing at all, occurrence 1 of the first site is
        forced so a chaos run always exercises at least one fault."""
        import numpy as np

        rng = np.random.default_rng(seed)
        sites = tuple(sites)
        spec = {
            site: [
                n for n in range(1, horizon + 1) if rng.random() < rate
            ]
            for site in sites
        }
        if not any(spec.values()) and sites:
            spec[sites[0]] = [1]
        return cls(spec)

    def check(self, site: str) -> None:
        """Count one occurrence of ``site``; raise if the plan says so."""
        with self._lock:
            n = self._seen.get(site, 0) + 1
            self._seen[site] = n
            hit = n in self.spec.get(site, ())
            if hit:
                self.fired.append((site, n))
        if hit:
            raise InjectedFault(site, n)

    @property
    def counts(self) -> dict[str, int]:
        """Occurrences observed so far per site (fired or not)."""
        with self._lock:
            return dict(self._seen)


# The installed plan.  Hooks read this exactly once per call; ``None``
# (the default, and the only state production code ever sees) short-
# circuits before any method call.
ACTIVE: FaultPlan | None = None


@contextlib.contextmanager
def installed(plan: FaultPlan):
    """Scope ``plan`` as the active plan, restoring the previous one."""
    global ACTIVE
    prev = ACTIVE
    ACTIVE = plan
    try:
        yield plan
    finally:
        ACTIVE = prev
