"""Background calibration: measurement-refined selection tables
(counterpart of src/repro/core/calibrate.py).

Vortex's bet (PAPER.md, Eq. 2-4) is that an analytical, hardware-derived
cost model picks kernels without runtime shape samples.  That keeps cold
start sample-free, but measured search beats analytical models at steady
state.  Here the serving stack trusts the analytical tables from the first
request, and IDLE time on the card refines them: no user traffic is ever
sampled, so the system stays sample-free in the paper's sense.

The pipeline, per compiled kernel:

  1. MEASURE: the top-K analytically-ranked candidates of each reachable
     bucket are timed with the interleaved min-vs-min harness
     (core/timing.py, shared with the bench gates), each through the
     executable the serving path would launch for it (the hand-written
     kernel at ``impl="cuda"``), built outside the kernel's executable
     cache so the serving ledger (DispatchStats, staging pools) is never
     touched.  Measurements run in the dtype and on the device of the
     calls the kernel has served (bf16 on the card when it has served
     none): float32 runs the FMA loop at every tile, so a float32 timing
     would rank tiles of a path bf16 serving never takes (ROADMAP C5);
  2. FIT or RE-RANK: a per-backend multiplicative coefficient is
     least-squares fitted over (predicted, measured) pairs.  A good fit
     (low max relative residual) refines EVERY bucket through
     ``cost_scale``; a bad fit falls back to measurement-only re-ranking.
     Either way, measured buckets are ground truth: wherever the refined
     model still disagrees with the measured-best candidate, that bucket's
     breakpoint interval is PINNED to the measured winner, so a calibrated
     table never picks worse than the measurements on any measured bucket;
  3. SWAP: the table is rebuilt OFFLINE through the same breakpoint sweep
     (``build_selection_table``) and published into the live
     ``RuntimeSelector`` with one attribute assignment (``install_table``):
     readers see entirely-old or entirely-new, and the bisect hot path is
     untouched.  A decode step's CUDA graph keeps the selection it was
     captured with (launch/graphs.py), as the reference's AOT decode
     programs keep theirs;
  4. PERSIST: results are written (tmp file + ``os.replace``) to a JSON file
     keyed by a hardware fingerprint (HardwareSpec descriptor + backends +
     impl + torch/CUDA/device identity + the kernel sources' digest), so a
     restarted engine loads the calibrated tables instead of re-measuring.
     Truncated or corrupt files are rejected and serving keeps the
     analytical tables.

The cache directory defaults to ``~/.cache/vortex`` and is overridable via
``$VORTEX_CACHE_DIR`` or ``CalibrationPolicy.cache_dir``, never inside the
repo.  A measurement never runs while a CUDA graph is being captured on the
calling thread (``_measure_bucket`` raises); every slice holds
:attr:`Calibrator.lock`, which ``DecodeGraphs.capture`` takes too, so a
calibration thread never synchronizes the card during another thread's
capture.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import threading
import time
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core.analyzer import StackedLattices
from repro_torch.core.engine import VortexKernel
from repro_torch.core.timing import interleaved_minima
from repro_torch.core.workloads import Workload
from repro_torch.runtime import faults

__all__ = [
    "CalibrationPolicy",
    "Calibrator",
    "BucketMeasurement",
    "calibration_cache_dir",
    "hardware_fingerprint",
    "fingerprint_key",
    "lattice_checksum",
]

_SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# Cache location + hardware fingerprint
# ---------------------------------------------------------------------------


def calibration_cache_dir(override: str | None = None) -> str:
    """The calibrated-table cache directory: explicit ``override`` wins,
    then ``$VORTEX_CACHE_DIR``, then ``~/.cache/vortex`` — never a path
    inside the repository."""
    if override:
        return os.path.expanduser(override)
    env = os.environ.get("VORTEX_CACHE_DIR")
    if env:
        return os.path.expanduser(env)
    return os.path.join(os.path.expanduser("~"), ".cache", "vortex")


def hardware_fingerprint(
    hw, backends: tuple[str, ...], impl: str, device
) -> dict:
    """A JSON-able descriptor of everything a measured time depends on: the
    HardwareSpec (name + per-backend peaks + native tiles), the executable
    implementation, the torch and CUDA versions, the device the
    measurements ran on (name and SM count), the host machine and, for
    ``impl="cuda"``, the digest of the kernel sources (an edited kernel
    changes every measured time).  Two processes with equal fingerprints
    may share calibrated tables; anything else must re-measure."""
    dev = torch.device(device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        name, sms = props.name, int(props.multi_processor_count)
    else:
        name, sms = platform.processor() or platform.machine(), 0
    fp = {
        "hardware": hw.name,
        "backends": {b: float(hw.backends[b]) for b in backends},
        "native_tile": {b: list(hw.native_tile[b]) for b in backends},
        "impl": impl,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": f"{dev.type}:{name}",
        "multi_processor_count": sms,
        "machine": platform.machine(),
    }
    if impl == "cuda":
        from repro_torch.kernels.build import source_digest

        fp["kernel_sources"] = source_digest()
    return fp


def fingerprint_key(fp: dict) -> str:
    """Stable 16-hex key of a fingerprint dict (the cache file name)."""
    blob = json.dumps(fp, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def lattice_checksum(stacked: StackedLattices) -> str:
    """Checksum of the stacked candidate space a calibration was fitted
    over.  Candidate indices are only meaningful against the same lattice
    (same tiles, same scored costs, same backend stacking order); a
    persisted entry whose checksum mismatches is stale and rejected."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(stacked.l1_tiles, np.int64).tobytes())
    h.update(np.ascontiguousarray(stacked.l1_costs, np.float64).tobytes())
    h.update(repr((stacked.backends, stacked.offsets)).encode())
    return h.hexdigest()[:16]


def _signature_key(wl: Workload) -> str:
    return repr(wl.signature)


def _capturing() -> bool:
    """True while the calling thread's current stream captures a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


# ---------------------------------------------------------------------------
# Policy + per-kernel state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CalibrationPolicy:
    """Knobs for the background calibrator (EngineConfig ``calibration*``).

    ``mode`` — "off" (never instantiate), "on-idle" (the continuous
    scheduler donates budgeted slices when its admission queue is empty),
    or "eager-warmup" (calibrate — loading from disk first — as each
    kernel is built).  ``budget_s`` bounds ONE donated slice, not the
    whole calibration; ``m_max``/``max_buckets`` bound the measured
    extent set per kernel; the rounds/patience knobs feed the interleaved
    min-vs-min harness (core/timing.py).  ``residual_threshold`` is the
    max relative fit error above which the per-backend coefficient fit is
    distrusted and the calibrator re-ranks from measurements only.
    """

    mode: str = "on-idle"
    top_k: int = 3
    budget_s: float = 0.25
    m_max: int = 512
    max_buckets: int = 8
    inner: int = 1
    min_rounds: int = 5
    max_rounds: int = 30
    patience: int = 3
    residual_threshold: float = 0.25
    cache_dir: str | None = None


@dataclasses.dataclass
class BucketMeasurement:
    """Wall-clock evidence for one measured bucket extent.

    ``seconds``/``predicted`` map candidate index -> measured best
    seconds / unscaled analytical seconds for the top-K candidates;
    ``analytical_idx`` is the unscaled-argmin winner over ALL candidates
    (always included in the measured set); ``rounds`` is how many timed
    rounds the harness ran (0 for a measurement loaded from disk)."""

    m: int
    analytical_idx: int
    seconds: dict[int, float]
    predicted: dict[int, float]
    rounds: int = 0

    @property
    def best_idx(self) -> int:
        return min(self.seconds, key=lambda i: self.seconds[i])


@dataclasses.dataclass
class _KernelState:
    kernel: VortexKernel
    pending: list[int]                     # bucket extents still to measure
    measured: dict[int, BucketMeasurement] = dataclasses.field(
        default_factory=dict
    )
    applied: bool = False                  # calibrated table installed
    loaded: bool = False                   # applied from disk, not measured
    skipped: str | None = None             # reason this kernel is excluded
    mode: str | None = None                # "coefficients" | "rerank"
    residual: float = 0.0
    backend_scale: dict[str, float] = dataclasses.field(default_factory=dict)
    pinned: dict[int, int] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0                   # calibration wall-clock


class Calibrator:
    """Measure, refit, rebuild, atomically swap, persist — per kernel.

    ``kernels`` is a zero-argument callable returning the LIVE kernels to
    calibrate (the vortex Engine passes a snapshot of its kernel table, so
    signatures built after calibration started are picked up by later
    slices).  ``device`` is the engine's device: what the fingerprint
    names, and where a kernel that has served no call is measured.  All
    mutation runs under :attr:`lock`: concurrent ``run_slice`` callers
    serialize, while serving threads never take it; the only cross-thread
    handoff is the selector's atomic table swap.
    """

    def __init__(
        self,
        kernels: Callable[[], Iterable[VortexKernel]],
        policy: CalibrationPolicy | None = None,
        device="cpu",
    ):
        self._kernels = kernels
        self.policy = policy or CalibrationPolicy()
        self.device = torch.device(device)
        self._lock = threading.RLock()
        self._states: dict[str, _KernelState] = {}
        self.counters = {
            "measurements": 0, "measured_buckets": 0, "fits": 0,
            "reranks": 0, "table_swaps": 0, "loads": 0, "saves": 0,
            "load_rejects": 0, "save_errors": 0, "store_rejects": 0,
            "slices": 0, "seconds": 0.0,
        }

    @property
    def lock(self) -> threading.RLock:
        """Held for every slice, load and save.  ``DecodeGraphs.capture``
        holds it too, so no measurement synchronizes the card during a
        capture on another thread."""
        return self._lock

    # -- planning -----------------------------------------------------------

    def _calibratable(self, kernel: VortexKernel) -> str | None:
        """None when the kernel can be measured without representative
        call args, else the reason it is skipped."""
        wl = kernel.workload
        if type(wl).exec_key is not Workload.exec_key:
            # Executables specialize on outer dims of real call args
            # (attention batch/heads): example_args alone can't produce
            # the executable serving would launch.
            return "exec-specialized (needs representative args)"
        if not wl.supports_staging:
            return "legacy workload contract"
        return None

    def _plan_extents(self, kernel: VortexKernel) -> list[int]:
        """The measured-extent set: every distinct dynamic bucket
        reachable up to ``policy.m_max`` (capped at the installed table's
        coverage), evenly subsampled to ``policy.max_buckets``."""
        pol = self.policy
        sel = kernel.selector
        table = sel.table
        m_hi = pol.m_max if table is None else min(pol.m_max, table.m_max)
        buckets = [b for b in sel.buckets_upto(max(m_hi, 1)) if b >= 1]
        if len(buckets) > pol.max_buckets:
            idx = np.unique(np.linspace(
                0, len(buckets) - 1, pol.max_buckets
            ).round().astype(int))
            buckets = [buckets[i] for i in idx]
        return buckets

    def _state_for(self, kernel: VortexKernel) -> _KernelState:
        key = _signature_key(kernel.workload)
        st = self._states.get(key)
        if st is None:
            skipped = self._calibratable(kernel)
            st = _KernelState(
                kernel=kernel,
                pending=[] if skipped else self._plan_extents(kernel),
                skipped=skipped,
            )
            self._states[key] = st
        return st

    def _sync(self) -> None:
        for kernel in list(self._kernels()):
            self._state_for(kernel)

    def pending(self) -> bool:
        """True when any enrolled kernel still has work (measurements or
        an un-applied fit)."""
        with self._lock:
            self._sync()
            return any(
                st.skipped is None and not st.applied
                for st in self._states.values()
            )

    # -- measurement --------------------------------------------------------

    def measure_as(self, kernel: VortexKernel) -> tuple[torch.dtype,
                                                        torch.device]:
        """(dtype, device) ``kernel`` is measured in: those of the calls it
        has served, else bf16 on the card and float32 on the CPU
        (ROADMAP C5)."""
        if kernel.served_as is not None:
            return kernel.served_as
        dtype = (torch.bfloat16 if self.device.type == "cuda"
                 else torch.float32)
        return dtype, self.device

    def _measure_bucket(self, st: _KernelState, m: int) -> None:
        """Time the top-K analytically-ranked candidates at extent ``m``
        through freshly built executables (the ones serving launches),
        interleaved min-vs-min."""
        if faults.ACTIVE is not None:
            faults.ACTIVE.check("calib_measure")
        if _capturing():
            raise RuntimeError(
                "calibration measurement during a CUDA graph capture")
        pol = self.policy
        kernel, sel = st.kernel, st.kernel.selector
        wl = kernel.workload
        costs = sel.candidate_costs(m)
        analytical_idx = int(np.argmin(costs))
        idxs = sel.rank_candidates(m, pol.top_k)
        if analytical_idx not in idxs:
            idxs.append(analytical_idx)
        if kernel.impl == "cuda":
            from repro_torch.kernels.build import library

            library()  # nvcc at first use, outside every timed window
        dtype, device = self.measure_as(kernel)
        calls = []
        for idx in idxs:
            cand = sel.candidate_selection(idx, m)
            fn = wl.build_executable(cand, impl=kernel.impl)
            warm = wl.example_args(cand, dtype=dtype, device=device)
            calls.append(lambda fn=fn, warm=warm: fn(*warm))
        t = interleaved_minima(
            calls, inner=pol.inner, min_rounds=pol.min_rounds,
            max_rounds=pol.max_rounds, patience=pol.patience,
        )
        st.measured[m] = BucketMeasurement(
            m=m,
            analytical_idx=analytical_idx,
            seconds={i: t.best_s[j] for j, i in enumerate(idxs)},
            predicted={i: float(costs[i]) for i in idxs},
            rounds=t.rounds,
        )
        self.counters["measurements"] += len(idxs)
        self.counters["measured_buckets"] += 1

    # -- fit / re-rank / swap -----------------------------------------------

    def _fit(self, st: _KernelState) -> None:
        """Per-backend least-squares coefficient fit, pin disagreements,
        rebuild the table offline, atomically swap it in."""
        stacked = st.kernel.selector.stacked
        by_backend: dict[str, list[tuple[float, float]]] = {}
        for meas in st.measured.values():
            for idx, sec in meas.seconds.items():
                by_backend.setdefault(stacked.backend_of(idx), []).append(
                    (meas.predicted[idx], sec)
                )
        scale: dict[str, float] = {}
        residual = 0.0
        for backend, pairs in by_backend.items():
            p = np.asarray([x for x, _ in pairs], np.float64)
            y = np.asarray([y for _, y in pairs], np.float64)
            denom = float(np.dot(p, p))
            alpha = float(np.dot(p, y)) / denom if denom > 0 else 1.0
            alpha = max(alpha, 1e-12)
            scale[backend] = alpha
            rel = np.abs(alpha * p - y) / np.maximum(y, 1e-12)
            residual = max(residual, float(np.max(rel)) if len(rel) else 0.0)

        st.residual = residual
        if residual <= self.policy.residual_threshold:
            st.mode = "coefficients"
            st.backend_scale = scale
            self.counters["fits"] += 1
        else:
            # The global fit extrapolates badly; don't let it move any
            # unmeasured bucket — re-rank from measurements only.
            st.mode = "rerank"
            st.backend_scale = {}
            self.counters["reranks"] += 1
        self._apply(st)

    def _scale_vector(self, st: _KernelState) -> np.ndarray | None:
        """(C,) per-candidate coefficients of a fit, or None.  A backend
        none of whose candidates was measured takes the largest fitted
        coefficient (ROADMAP C7): the reference's 1.0 would price it the
        coefficient's factor cheaper than every measured candidate, and
        it would take every extent no pin holds."""
        if not st.backend_scale:
            return None
        stacked = st.kernel.selector.stacked
        unmeasured = max(st.backend_scale.values())
        return np.asarray([
            st.backend_scale.get(stacked.backend_of(i), unmeasured)
            for i in range(stacked.num_candidates)
        ], np.float64)

    def _apply(self, st: _KernelState) -> None:
        """Pin measured buckets where the refined model still disagrees
        with the measured-best candidate, then rebuild + swap.  After the
        swap, the table's pick on EVERY measured bucket is the measured
        winner — never worse than the analytical pick there."""
        sel = st.kernel.selector
        vec = self._scale_vector(st)
        pinned: dict[int, int] = {}
        for m, meas in st.measured.items():
            model_winner = int(np.argmin(sel.candidate_costs(m) * (
                vec if vec is not None else 1.0
            )))
            best = meas.best_idx
            if model_winner != best:
                pinned[m] = best
        st.pinned = pinned
        table = sel.build_calibrated_table(cost_scale=vec, pinned=pinned)
        sel.install_table(
            table, cost_scale=vec, pinned=pinned,
            calibration_seconds=st.seconds,
        )
        st.applied = True
        self.counters["table_swaps"] += 1

    # -- driving ------------------------------------------------------------

    def run_slice(self, budget_s: float | None = None) -> int:
        """One budgeted calibration slice: measure pending buckets until
        the budget is spent, finalizing (fit + swap + persist) any kernel
        whose measurement set completes.  Returns buckets measured.  Safe
        to call from an idle serving loop: all work is off the dispatch
        path, and the only serving-visible effect is the atomic table
        swap.  A measurement that fails marks its kernel skipped
        (``"measurement failed"``) and serving keeps its analytical
        table."""
        budget = self.policy.budget_s if budget_s is None else budget_s
        done = 0
        t0 = time.perf_counter()
        with self._lock:
            self.counters["slices"] += 1
            self._sync()
            for st in self._states.values():
                if st.skipped is not None or st.applied:
                    continue
                while st.pending:
                    m = st.pending[0]
                    tb = time.perf_counter()
                    try:
                        self._measure_bucket(st, m)
                    except Exception:
                        st.skipped = "measurement failed"
                        break
                    finally:
                        dt = time.perf_counter() - tb
                        st.seconds += dt
                        self.counters["seconds"] += dt
                    st.pending.pop(0)
                    done += 1
                    if time.perf_counter() - t0 >= budget:
                        break
                if not st.pending and st.skipped is None and st.measured:
                    tb = time.perf_counter()
                    self._fit(st)
                    st.seconds += time.perf_counter() - tb
                    self._save_quietly()
                if time.perf_counter() - t0 >= budget:
                    break
        return done

    def run(self) -> dict:
        """Calibrate everything currently pending to completion (the
        eager-warmup path and the CLI); returns :meth:`stats`."""
        while self.pending():
            if self.run_slice(budget_s=float("inf")) == 0:
                break
        return self.stats()

    # -- persistence --------------------------------------------------------

    def fingerprint(self) -> dict:
        for kernel in list(self._kernels()):
            sel = kernel.selector
            return hardware_fingerprint(
                sel._hw, tuple(sorted(sel.scored)), kernel.impl, self.device
            )
        raise RuntimeError("no kernels to fingerprint")

    def cache_path(self) -> str:
        d = calibration_cache_dir(self.policy.cache_dir)
        return os.path.join(d, f"{fingerprint_key(self.fingerprint())}.json")

    def _save_quietly(self) -> None:
        try:
            self.save()
        except Exception:
            self.counters["save_errors"] += 1
            self.counters["store_rejects"] += 1

    def save(self, path: str | None = None) -> str:
        """Persist every applied calibration (tmp file + os.replace: a
        reader never observes a partial file from a clean writer; a
        killed writer's leftovers are caught by load's checks)."""
        if faults.ACTIVE is not None:
            faults.ACTIVE.check("cache_io")
        with self._lock:
            payload = {
                "version": _SCHEMA_VERSION,
                "fingerprint": self.fingerprint(),
                "kernels": {},
            }
            for key, st in self._states.items():
                if not st.applied or st.mode is None:
                    continue
                table = st.kernel.selector.table_if_built
                payload["kernels"][key] = {
                    "lattice": lattice_checksum(st.kernel.selector.stacked),
                    "mode": st.mode,
                    "residual": st.residual,
                    "backend_scale": st.backend_scale,
                    "pinned": {str(m): i for m, i in st.pinned.items()},
                    "m_max": table.m_max if table is not None else 0,
                    "seconds": st.seconds,
                    "measurements": {
                        str(m): {
                            "analytical_idx": meas.analytical_idx,
                            "seconds": {
                                str(i): s for i, s in meas.seconds.items()
                            },
                            "predicted": {
                                str(i): p for i, p in meas.predicted.items()
                            },
                        }
                        for m, meas in st.measured.items()
                    },
                }
            path = path or self.cache_path()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            if faults.ACTIVE is not None:
                faults.ACTIVE.check("cache_io")
            os.replace(tmp, path)
            self.counters["saves"] += 1
            return path

    def load(self, path: str | None = None) -> int:
        """Apply persisted calibrations to the current kernels; returns
        how many kernels were calibrated FROM DISK (zero re-measurements).

        Every reject path is silent-but-counted (``load_rejects``) and
        keeps the analytical tables: missing file, truncated or corrupt
        JSON, schema/fingerprint mismatch, stale lattice checksum,
        out-of-range candidate indices.
        """
        with self._lock:
            self._sync()
            try:
                path = path or self.cache_path()
            except RuntimeError:
                return 0
            try:
                if faults.ACTIVE is not None:
                    faults.ACTIVE.check("cache_io")
                with open(path) as f:
                    data = json.load(f)
                if data.get("version") != _SCHEMA_VERSION:
                    raise ValueError("schema version mismatch")
                mine = fingerprint_key(self.fingerprint())
                theirs = fingerprint_key(dict(data["fingerprint"]))
                if mine != theirs:
                    raise ValueError("hardware fingerprint mismatch")
                entries = data["kernels"]
                if not isinstance(entries, dict):
                    raise ValueError("malformed kernels section")
            except FileNotFoundError:
                return 0
            except Exception:
                self.counters["load_rejects"] += 1
                return 0

            applied = 0
            for key, st in self._states.items():
                if st.applied or st.skipped is not None:
                    continue
                entry = entries.get(key)
                if entry is None:
                    continue
                try:
                    applied += self._apply_entry(st, entry)
                except Exception:
                    self.counters["load_rejects"] += 1
            if applied:
                self.counters["loads"] += applied
            return applied

    def _apply_entry(self, st: _KernelState, entry: dict) -> int:
        sel = st.kernel.selector
        stacked = sel.stacked
        if entry["lattice"] != lattice_checksum(stacked):
            raise ValueError("stale lattice checksum")
        mode = entry["mode"]
        if mode not in ("coefficients", "rerank"):
            raise ValueError(f"unknown mode {mode!r}")
        scale = {str(b): float(a) for b, a in entry["backend_scale"].items()}
        pinned = {int(m): int(i) for m, i in entry["pinned"].items()}
        n = stacked.num_candidates
        if any(not 0 <= i < n for i in pinned.values()):
            raise ValueError("pinned candidate index out of range")
        st.mode = mode
        st.residual = float(entry.get("residual", 0.0))
        st.backend_scale = scale if mode == "coefficients" else {}
        st.pinned = pinned
        for m_str, meas in entry.get("measurements", {}).items():
            m = int(m_str)
            st.measured[m] = BucketMeasurement(
                m=m,
                analytical_idx=int(meas["analytical_idx"]),
                seconds={int(i): float(s)
                         for i, s in meas["seconds"].items()},
                predicted={int(i): float(p)
                           for i, p in meas["predicted"].items()},
            )
        vec = self._scale_vector(st)
        table = sel.build_calibrated_table(cost_scale=vec, pinned=pinned)
        sel.install_table(table, cost_scale=vec, pinned=pinned)
        st.applied = True
        st.loaded = True
        st.pending = []
        self.counters["table_swaps"] += 1
        return 1

    # -- reporting ----------------------------------------------------------

    def _candidate_index(self, stacked: StackedLattices) -> dict:
        return {
            (stacked.backend_of(i), stacked.strategy_for(i).tiles): i
            for i in range(stacked.num_candidates)
        }

    def report(self) -> dict:
        """Measured-vs-analytical selection quality per kind (the bench's
        ``calibration`` section).

        Per measured bucket: the ANALYTICAL pick's measured seconds, the
        measured-best seconds, and the CALIBRATED table's pick (resolved
        through a live post-swap ``select``) with its measured seconds,
        beside the three picks' candidate indices, the measured candidates
        per backend and the harness's rounds.
        ``never_worse_on_measured`` is the gate.
        """
        with self._lock:
            out: dict[str, dict] = {}
            for st in self._states.values():
                if not st.measured or not st.applied:
                    continue
                sel = st.kernel.selector
                index = self._candidate_index(sel.stacked)
                agree = 0
                regrets: list[float] = []
                worse = 0
                buckets = []
                for m, meas in sorted(st.measured.items()):
                    pick = sel.select(m)
                    pick_idx = index.get((pick.backend, pick.strategy.tiles))
                    best = meas.best_idx
                    t_best = meas.seconds[best]
                    t_analytical = meas.seconds[meas.analytical_idx]
                    t_pick = meas.seconds.get(pick_idx)
                    if meas.analytical_idx == best:
                        agree += 1
                    if t_pick is None:
                        worse += 1  # pick fell outside the measured set
                        regrets.append(float("nan"))
                    else:
                        if t_pick > t_analytical * (1 + 1e-9):
                            worse += 1
                        regrets.append(t_pick / t_best - 1.0)
                    buckets.append({
                        "m": m,
                        "analytical_us": t_analytical * 1e6,
                        "best_us": t_best * 1e6,
                        "calibrated_us": (
                            t_pick * 1e6 if t_pick is not None else None
                        ),
                        "analytical_idx": meas.analytical_idx,
                        "best_idx": best,
                        "calibrated_idx": pick_idx,
                        "candidates": {
                            b: sum(sel.stacked.backend_of(i) == b
                                   for i in meas.seconds)
                            for b in sorted({sel.stacked.backend_of(i)
                                             for i in meas.seconds})
                        },
                        "rounds": meas.rounds,
                    })
                kind = st.kernel.workload.kind
                finite = [r for r in regrets if r == r]
                out[kind] = {
                    "mode": st.mode,
                    "residual": st.residual,
                    "backend_scale": st.backend_scale,
                    "measured_buckets": len(st.measured),
                    "pinned_buckets": len(st.pinned),
                    "agreement_rate": agree / max(len(st.measured), 1),
                    "mean_regret_vs_best": (
                        float(np.mean(finite)) if finite else 0.0
                    ),
                    "never_worse_on_measured": worse == 0,
                    "loaded_from_disk": st.loaded,
                    "buckets": buckets,
                }
            return out

    def skipped(self) -> dict[str, str]:
        """Kind -> the reason each skipped kernel is not calibrated."""
        with self._lock:
            return {st.kernel.workload.kind: st.skipped
                    for st in self._states.values()
                    if st.skipped is not None}

    def stats(self) -> dict:
        """Counter snapshot for ``Engine.stats()["calibration"]``."""
        with self._lock:
            states = list(self._states.values())
            return {
                "enabled": True,
                "mode": self.policy.mode,
                "kernels": len(states),
                "applied": sum(st.applied for st in states),
                "loaded_from_disk": sum(st.loaded for st in states),
                "skipped": sum(st.skipped is not None for st in states),
                "pending_buckets": sum(
                    len(st.pending) for st in states if st.skipped is None
                ),
                **dict(self.counters),
            }
