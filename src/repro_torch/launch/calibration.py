"""Serving-side drivers for the background calibrator (core/calibrate.py;
counterpart of src/repro/launch/calibration.py).

Three entry points, in increasing autonomy:

  * :func:`warm_from_disk`: load persisted calibrated tables (by hardware
    fingerprint) into an engine at startup; zero measurements, and no
    effect when nothing matching is on disk;
  * :class:`CalibrationDaemon`: a thread that donates budgeted slices
    whenever the engine has pending calibration work, for serving stacks
    WITHOUT a scheduler loop of their own (``ContinuousScheduler`` donates
    its idle ticks instead and needs no daemon).  Its slices hold the
    calibrator's lock, which ``DecodeGraphs.capture`` takes too, so no
    slice synchronizes the card while another thread captures a graph;
  * :func:`main`: the CLI.  It builds an engine over the standard bench
    workloads (gemm and conv2d calibrate; attention is enrolled to show it
    is skipped; on the card, in bf16, also the grouped GEMM at
    granite-moe-1b-a400m's expert widths), runs one full calibration pass
    and prints the measured-vs-analytical report.  It exits 1 if any
    calibrated table picks worse than the analytical pick on a measured
    bucket.

    PYTHONPATH=src python -m repro_torch.launch.calibration          # card
    PYTHONPATH=src python -m repro_torch.launch.calibration --device cpu --smoke
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import threading

__all__ = ["warm_from_disk", "CalibrationDaemon", "run_calibration", "main"]


def warm_from_disk(engine) -> int:
    """Load persisted calibrated tables into ``engine``'s kernels; returns
    how many kernels were calibrated from disk (0 when calibration is off,
    nothing is persisted, or the fingerprint/lattice doesn't match)."""
    cal = engine.calibrator
    return cal.load() if cal is not None else 0


class CalibrationDaemon:
    """Background thread feeding budgeted slices to ``engine.calibrator``.

    ``interval_s`` is the sleep between slices, the coarse "is the process
    idle enough" knob for hosts without a scheduler loop.  The thread
    waits while nothing is pending (:meth:`poke` wakes it early, e.g.
    after a new kernel was built).  ``stop()`` is prompt: at most one
    in-flight slice (bounded by ``calibration_budget_s``) completes after
    it.
    """

    def __init__(self, engine, interval_s: float = 1.0):
        self.engine = engine
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "CalibrationDaemon":
        if self.engine.calibrator is None:
            return self  # calibration off: never spawn the thread
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="vortex-calibration", daemon=True
            )
            self._thread.start()
        return self

    def poke(self) -> None:
        """Wake the daemon early (e.g. after compiling a new kernel)."""
        self._wake.set()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        cal = self.engine.calibrator
        cal.load()  # restart path: persisted tables beat re-measuring
        while not self._stop.is_set():
            try:
                if cal.pending():
                    cal.run_slice()
                elif not self._wake.wait(timeout=self.interval_s * 10):
                    continue
            except Exception:
                # Never let calibration kill a serving process.
                logging.getLogger(__name__).exception(
                    "calibration daemon stopped after a failed slice")
                return
            self._wake.clear()
            self._stop.wait(timeout=self.interval_s)


def run_calibration(engine, *, load: bool = True) -> dict:
    """One full (non-budgeted) calibration pass over ``engine``'s current
    kernels: optionally load persisted tables first, measure the rest to
    completion, and return the measured-vs-analytical report plus the
    calibrator counters."""
    cal = engine.calibrator
    if cal is None:
        raise ValueError(
            'engine has calibration="off"; construct it with '
            'calibration="on-idle" or "eager-warmup"'
        )
    if load:
        cal.load()
    cal.run()
    return {"report": cal.report(), "stats": cal.stats()}


SMOKE_POLICY = dict(m_max=192, max_buckets=3, min_rounds=3, max_rounds=8,
                    patience=2)


def main(argv: list[str] | None = None) -> int:
    import numpy as np
    import torch

    from repro_torch.vortex import Engine

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the calibration report as JSON")
    ap.add_argument("--cache-dir", default=None,
                    help="persistence dir (default: $VORTEX_CACHE_DIR "
                         "or ~/.cache/vortex)")
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--budget-s", type=float, default=0.25)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced bucket set / round counts")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels, bf16) or cpu "
                         "(their plain versions, float32)")
    args = ap.parse_args(argv)

    on_card = torch.device(args.device).type == "cuda"
    eng = Engine(
        "h100_sxm" if on_card else "host_cpu", device=args.device,
        empirical_levels=(),
        calibration="on-idle",
        calibration_top_k=args.top_k,
        calibration_budget_s=args.budget_s,
        calibration_cache_dir=args.cache_dir,
    )
    dtype = torch.bfloat16 if on_card else torch.float32
    rng = np.random.default_rng(23)

    def arr(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            device=args.device, dtype=dtype)

    # The standard bench mix: gemm and conv2d calibrate (default
    # exec_key); attention is enrolled to show the calibrator skips
    # exec-specialized kernels instead of mis-measuring them.
    eng.dispatch("gemm", arr(33, 256), arr(256, 128))
    eng.dispatch("conv2d", arr(2, 14, 14, 8), arr(3, 3, 8, 16))
    kv = arr(1, 2, 67, 64)
    eng.dispatch("attention", arr(1, 4, 67, 64), kv, kv)
    if on_card:
        # granite-moe-1b-a400m's expert FFN: 32 experts of 1024 -> 512,
        # 8 sequences a batch (G = 256 groups).
        counts = torch.full((256,), 20, dtype=torch.int32, device=args.device)
        eng.dispatch("grouped_gemm", arr(256, 20, 1024), arr(32, 1024, 512),
                     counts)

    if args.smoke:
        cal = eng.calibrator
        cal.policy = dataclasses.replace(cal.policy, **SMOKE_POLICY)
    out = run_calibration(eng)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
    ok = True
    for kind, rep in out["report"].items():
        print(
            f"{kind}: mode={rep['mode']} "
            f"agreement={rep['agreement_rate']:.2f} "
            f"pinned={rep['pinned_buckets']}/{rep['measured_buckets']} "
            f"never_worse={rep['never_worse_on_measured']}"
        )
        ok = ok and rep["never_worse_on_measured"]
    for kind, why in eng.calibrator.skipped().items():
        print(f"{kind}: skipped ({why})")
    s = out["stats"]
    where = torch.cuda.get_device_name(0) if on_card else "cpu"
    print(
        f"calibrated {s['applied']}/{s['kernels']} kernels "
        f"({s['skipped']} skipped) in {s['seconds']:.2f}s on {where}; "
        f"saved={s['saves']} loaded={s['loaded_from_disk']}"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
