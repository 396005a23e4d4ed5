"""Persistent quarantine of known-bad kernel candidates (counterpart of
src/repro/core/denylist.py; DESIGN.md §11).

The degradation ladder (core/engine.py) quarantines a candidate the moment
it fails at executable build or launch and re-selects the next-best
analytical candidate from the stacked lattice.  This store makes the
quarantine survive restarts: entries persist next to the calibration cache
under the same hardware fingerprint key (``<fingerprint>.deny.json``), so a
fresh engine on the same host skips candidates this host has already proven
bad -- without re-failing them.

The key is :func:`~repro_torch.core.calibrate.hardware_fingerprint` of
(hardware, backends, impl, device).  With ``impl="cuda"`` that fingerprint
holds the digest of the kernel sources (csrc/*.cu, *.cuh), so an edited
kernel starts with an empty denylist: a fix is never hidden behind the
quarantine its broken predecessor earned.

The file maps a workload signature key (``repr(wl.signature)``, the key
the calibrator uses) to a list of quarantine keys (``repr((bucket,
backend, tiles))`` strings).  I/O is quiet and counted: a corrupt or
foreign file is ignored (``load_rejects``), a failed write drops the
persistence but never the in-memory quarantine (``store_rejects``) -- the
ladder works identically with no disk at all.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading

from repro_torch.runtime import faults

__all__ = ["DenylistStore"]

_SCHEMA_VERSION = 1


class DenylistStore:
    """Fingerprint-keyed persistent denylist shared by an engine's kernels.

    Loading is lazy (first :meth:`get`) and at most once; every
    :meth:`add` rewrites the file atomically (tmp + ``os.replace``) so a
    mid-write kill leaves the previous snapshot intact.
    """

    def __init__(
        self,
        hw,
        backends: tuple[str, ...],
        impl: str,
        device: str,
        *,
        cache_dir: str | None = None,
    ):
        self._hw = hw
        self._backends = tuple(backends)
        self._impl = impl
        self._device = device
        self._cache_dir = cache_dir
        self._lock = threading.Lock()
        self._loaded = False
        self._path: str | None = None
        self._entries: dict[str, list[str]] = {}
        self.counters = {
            "loads": 0,
            "load_rejects": 0,
            "saves": 0,
            "store_rejects": 0,
        }

    # -- location -----------------------------------------------------------

    def path(self) -> str:
        """``<calibration_cache_dir>/<fingerprint_key>.deny.json``."""
        if self._path is None:
            from repro_torch.core.calibrate import (
                calibration_cache_dir,
                fingerprint_key,
                hardware_fingerprint,
            )

            fp = hardware_fingerprint(
                self._hw, self._backends, self._impl, self._device
            )
            self._path = os.path.join(
                calibration_cache_dir(self._cache_dir),
                f"{fingerprint_key(fp)}.deny.json",
            )
        return self._path

    # -- query / update -----------------------------------------------------

    def get(self, sig_key: str) -> frozenset[str]:
        """Quarantine keys persisted for one workload signature."""
        with self._lock:
            self._load_once()
            return frozenset(self._entries.get(sig_key, ()))

    def add(self, sig_key: str, qkey: str) -> None:
        """Record a quarantined candidate and persist quietly."""
        with self._lock:
            self._load_once()
            keys = self._entries.setdefault(sig_key, [])
            if qkey not in keys:
                keys.append(qkey)
            self._save_quietly()

    # -- quiet, counted I/O -------------------------------------------------

    def _load_once(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        path = self.path()
        if not os.path.exists(path):
            return
        try:
            if faults.ACTIVE is not None:
                faults.ACTIVE.check("cache_io")
            with open(path) as f:
                data = json.load(f)
            if data.get("version") != _SCHEMA_VERSION:
                raise ValueError("schema version mismatch")
            entries = data["kernels"]
            if not all(
                isinstance(ks, list) and all(isinstance(k, str) for k in ks)
                for ks in entries.values()
            ):
                raise ValueError("malformed denylist entries")
            self._entries = {str(s): list(ks) for s, ks in entries.items()}
            self.counters["loads"] += 1
        except Exception:
            self.counters["load_rejects"] += 1
            self._entries = {}

    def _save_quietly(self) -> None:
        path = self.path()
        try:
            if faults.ACTIVE is not None:
                faults.ACTIVE.check("cache_io")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            blob = json.dumps(
                {"version": _SCHEMA_VERSION, "kernels": self._entries},
                indent=1,
            )
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(path), suffix=".tmp"
            )
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(blob)
                if faults.ACTIVE is not None:
                    faults.ACTIVE.check("cache_io")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            self.counters["saves"] += 1
        except Exception:
            self.counters["store_rejects"] += 1
