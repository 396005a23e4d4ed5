"""Heartbeat / straggler detection (a copy of
src/repro/runtime/heartbeat.py).

Each host reports per-step wall-clock durations; the monitor flags
stragglers with a median-absolute-deviation rule (robust to the long tail a
mean/std rule would be pulled by) and flags *dead* hosts that have missed
``dead_after`` heartbeat intervals.  At 1000+ nodes this runs on the
coordinator; here it is exercised by the test-suite and the example script
with simulated hosts.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

__all__ = ["StepMonitor"]


@dataclasses.dataclass
class HostState:
    last_seen: float
    durations: collections.deque


class StepMonitor:
    def __init__(
        self,
        window: int = 32,
        mad_threshold: float = 5.0,
        dead_after: float = 60.0,
        clock=time.monotonic,
    ):
        self._window = window
        self._mad = mad_threshold
        self._dead_after = dead_after
        self._clock = clock
        self._hosts: dict[int, HostState] = {}

    def record(self, host: int, step: int, seconds: float) -> None:
        st = self._hosts.get(host)
        now = self._clock()
        if st is None:
            st = HostState(now, collections.deque(maxlen=self._window))
            self._hosts[host] = st
        st.last_seen = now
        st.durations.append(float(seconds))

    def _recent(self, host: int) -> float | None:
        st = self._hosts.get(host)
        if not st or not st.durations:
            return None
        return float(np.median(list(st.durations)[-8:]))

    def stragglers(self) -> list[int]:
        """Hosts whose recent step time deviates > threshold * MAD from the
        fleet median."""
        meds = {
            h: m for h in self._hosts
            if (m := self._recent(h)) is not None
        }
        if len(meds) < 3:
            return []
        values = np.array(list(meds.values()))
        fleet_med = np.median(values)
        mad = np.median(np.abs(values - fleet_med)) + 1e-9
        return sorted(
            h for h, m in meds.items()
            if (m - fleet_med) / mad > self._mad
        )

    def dead_hosts(self) -> list[int]:
        now = self._clock()
        return sorted(
            h for h, st in self._hosts.items()
            if now - st.last_seen > self._dead_after
        )

    def healthy_hosts(self) -> list[int]:
        dead = set(self.dead_hosts())
        return sorted(h for h in self._hosts if h not in dead)
