"""Chaos smoke of the PyTorch/CUDA port: a serving session under a
random-but-seeded fault plan (counterpart of tools/chaos.py).

Two phases with the reference's gates; any gate failure exits 1:

  A. ENGINE LADDER -- a gemm dispatch stream over 6 seeded extents on a
     fresh Engine under precompile/aot_launch faults.  Gates: every
     output matches its reference, at least one fault fired and at least
     one degradation rung ran (a quarantined retry, the impl="torch"
     rung, or on the card an exhausted ladder).  On the card:
     ``vortex.ops.gemm`` in bfloat16 at K = N = 768 through the
     hand-written kernels, held against a float32 ``torch.matmul`` of the
     same bf16 operands within BF16_TOL of its largest magnitude (one
     bf16 ulp of the final cast: the rungs accumulate in different
     orders, so the outputs are not bit-identical).  The card has no
     impl="torch" rung, so a call whose 1 + max_kernel_retries candidates
     all fail raises LadderExhaustedError: that is its gate's one allowed
     exception, only where exactly that many faults fired inside the
     call, and the call is dispatched again after the plan, with no
     quarantine left behind, and must match.  On the CPU: the
     reference's 64 x 64 float32 stream on the host_cpu lattice, within
     1e-5 of the no-fault run; every call must return.
  B. SERVING ISOLATION -- paper-gpt2-124m behind ContinuousScheduler under
     pool_lease/scheduler_step faults, against a no-fault serial
     ``generate()`` on the same server.  Gates: every submitted request
     resolves (tokens or a typed RequestError), non-faulted requests'
     tokens equal serial's, and the kv pool's ``leases_active`` is 0
     after drain + close.  On the card: full width (12 layers, d_model
     768) with decode and prefill graphs on, in float32 so tokens compare
     exactly (as chip_smoke.py phase 4f does); on the CPU: the smoke
     config, eager.

Usage:
    PYTHONPATH=src python tools/chaos_torch.py [--seed N]          # card
    PYTHONPATH=src python tools/chaos_torch.py --device cpu [--seed N]

The plan is deterministic in the seed (seeds 0..2 are the reference's CI
set), so a failing seed reproduces bit for bit.  ``run(seed, device)``
is the in-process entry point (chip_smoke.py phase 7, the tests).
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.runtime import faults  # noqa: E402

BF16_TOL = 2.0 ** -7


class Gates:
    """The gates of one run, printed as they are decided."""

    def __init__(self) -> None:
        self.failures: list[str] = []

    def __call__(self, ok: bool, label: str) -> None:
        print(f"  [{'PASS' if ok else 'FAIL'}] {label}")
        if not ok:
            self.failures.append(label)


def phase_a_engine(seed: int, device: torch.device, gate: Gates) -> dict:
    """Kernel degradation ladder under build/launch faults."""
    from repro_torch.core.engine import LadderExhaustedError
    from repro_torch.vortex import Engine

    print(f"phase A: engine ladder (seed={seed}, device={device})")
    rng = np.random.default_rng(seed)
    extents = [int(m) for m in rng.integers(17, 300, size=6)]
    if device.type == "cuda":
        d, dtype = 768, torch.bfloat16

        def engine():
            return Engine(denylist_persist=False)
    else:
        d, dtype = 64, torch.float32

        def engine():
            return Engine("host_cpu", device="cpu", empirical_levels=(),
                          denylist_persist=False)
    w = torch.from_numpy(rng.normal(size=(d, d))).to(device, dtype)
    xs = [torch.from_numpy(rng.normal(size=(m, d))).to(device, dtype)
          for m in extents]

    def run_stream(eng):
        return [eng.dispatch("gemm", x, w) for x in xs]

    if device.type == "cuda":
        ref = [x.float() @ w.float() for x in xs]
    else:
        # No-fault reference (denylist off: each phase is hermetic).
        ref = run_stream(engine())

    plan = faults.FaultPlan.random(
        seed, sites=("precompile", "aot_launch"), rate=0.3, horizon=40
    )
    eng = engine()
    retries = eng.config.max_kernel_retries
    # exhausted: call index -> (faults fired in it, quarantines it left)
    got, exhausted = [], {}

    def quarantined() -> int:
        return eng.stats().get("gemm", {}).get("quarantined", 0)

    with faults.installed(plan):
        for i, x in enumerate(xs):
            before, q0 = len(plan.fired), quarantined()
            try:
                got.append(eng.dispatch("gemm", x, w))
            except LadderExhaustedError:
                exhausted[i] = (len(plan.fired) - before, quarantined() - q0)
                got.append(None)
            except Exception as exc:  # the ladder must absorb the rest
                gate(False, f"no unhandled exception from dispatch "
                            f"({exc!r})")
                return {}
    stats = eng.stats()["gemm"]
    rungs = stats["quarantined"] + stats["fallbacks"] + len(exhausted)
    print(
        f"  extents {extents}; plan fired {len(plan.fired)} fault(s) "
        f"{plan.fired}; quarantined={stats['quarantined']} "
        f"fallbacks={stats['fallbacks']} exhausted calls "
        f"{sorted(exhausted)}"
    )
    gate(len(plan.fired) >= 1, "fault plan fired at least once")
    gate(rungs >= 1, "at least one degradation rung exercised")
    if exhausted:
        gate(device.type == "cuda"
             and all(n == 1 + retries for n, _ in exhausted.values()),
             f"a call raised LadderExhaustedError only on the card, after "
             f"1 + {retries} injected faults inside it")
        gate(all(q == 0 for _, q in exhausted.values()),
             "an exhausted call rolled back its quarantines")
        for i in exhausted:  # no plan now: the kernels serve the call
            got[i] = eng.dispatch("gemm", xs[i], w)
    if device.type == "cuda":
        errs = [float((g.float() - r).abs().max() / r.abs().max())
                for g, r in zip(got, ref)]
        print(f"  max |out - f32 matmul| / max |f32 matmul|: {max(errs):.3e}")
        gate(all(np.isfinite(e) and e <= BF16_TOL for e in errs),
             f"faulted outputs within {BF16_TOL:g} of a float32 matmul")
    else:
        gate(all(torch.allclose(g, r, atol=1e-5) for g, r in zip(got, ref)),
             "faulted outputs allclose to no-fault reference")
    return {"fired": list(plan.fired), "quarantined": stats["quarantined"],
            "fallbacks": stats["fallbacks"], "exhausted": sorted(exhausted)}


def phase_b_serving(seed: int, device: torch.device, gate: Gates) -> dict:
    """Per-request isolation under pool/scheduler faults."""
    from repro_torch.launch.scheduler import ContinuousScheduler
    from repro_torch.launch.serve import Request, RequestError, VortexServer
    from repro_torch.models.registry import get_config, get_smoke_config

    print(f"phase B: serving isolation (seed={seed}, device={device})")
    arch = "paper-gpt2-124m"
    if device.type == "cuda":
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
    else:
        cfg = get_smoke_config(arch)
    server = VortexServer(cfg, max_cache=256, device=device)
    rng = np.random.default_rng(seed)
    reqs = [
        Request(
            tokens=rng.integers(0, cfg.vocab, (1, int(s))).astype(np.int64),
            max_new=6,
        )
        for s in rng.integers(24, 48, size=6)
    ]

    # Serial no-fault reference, and a warm pass so the faulted run's
    # executables exist (faults target serving sites, not the kernels).
    serial = [server.generate(r) for r in reqs]

    plan = faults.FaultPlan.random(
        seed, sites=("pool_lease", "scheduler_step"), rate=0.04, horizon=60
    )
    # The random draw can land only on occurrences the short run never
    # reaches; guarantee one early scheduler fault (deterministic in the
    # seed) so the isolation gates are never vacuous.
    spec = {site: set(occs) for site, occs in plan.spec.items()}
    spec.setdefault("scheduler_step", set()).add(
        2 + int(np.random.default_rng(seed + 1).integers(0, 4))
    )
    plan = faults.FaultPlan(spec)
    sched = ContinuousScheduler(server, batch_rows=8)
    with faults.installed(plan):
        rids = [sched.submit(r) for r in reqs]
        try:
            results = sched.drain()
        except Exception as exc:
            gate(False, f"no unhandled exception from drain ({exc!r})")
            sched.close()
            return {}
    sched.close()
    pool = server.kv_pool.stats()
    errors = {
        rid for rid, out in results.items() if isinstance(out, RequestError)
    }
    matched = sum(
        1
        for rid, r in zip(rids, serial)
        if rid not in errors and np.array_equal(results[rid], r)
    )
    print(
        f"  plan fired {len(plan.fired)} fault(s) {plan.fired}; "
        f"{len(results)} resolved, {len(errors)} typed error(s), "
        f"{matched} token-identical to serial; "
        f"leases_active={pool['leases_active']}"
    )
    gate(len(plan.fired) >= 1, "fault plan fired at least once")
    gate(
        set(rids) == set(results),
        "every submitted request resolved (tokens or RequestError)",
    )
    gate(
        matched == len(rids) - len(errors),
        "non-faulted requests token-identical to serial",
    )
    gate(pool["leases_active"] == 0, "leases_active == 0 after drain+close")
    return {"fired": list(plan.fired), "errors": len(errors),
            "matched": matched}


def run(seed: int, device="cuda") -> list[str]:
    """Both phases for ``seed``; the labels of the gates that failed."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    gate = Gates()
    phase_a_engine(seed, dev, gate)
    phase_b_serving(seed, dev, gate)
    return gate.failures


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (smoke config, plain "
                         "versions)")
    args = ap.parse_args()
    failures = run(args.seed, args.device)
    if failures:
        print(f"chaos: {len(failures)} gate(s) FAILED: {failures}")
        return 1
    print("chaos: all gates passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
