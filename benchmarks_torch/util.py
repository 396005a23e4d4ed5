"""Shared timing utilities for the port's benchmark harness."""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.timing import synchronize  # noqa: E402

__all__ = [
    "bench_args", "card_line", "dtype_for", "emit", "hardware_for",
    "randn", "time_call",
]


def bench_args(argv=None):
    """A bench module's arguments: ``--device`` (the card by default;
    ``cpu`` runs the plain versions).  Unknown flags are ignored, so the
    runner can forward ``--smoke`` to every module."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    return ap.parse_known_args(argv)[0]


def hardware_for(device) -> str:
    """The lattice a bench prices on a device: the H100's on the card, the
    host CPU's on the CPU (the reference's benches run ``host_cpu``)."""
    import torch

    return "h100_sxm" if torch.device(device).type == "cuda" else "host_cpu"


def dtype_for(device):
    """bf16 on the card (the tensor-core path), float32 on the CPU."""
    import torch

    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def randn(rng, shape, device, dtype=None, scale: float = 1.0):
    """Seeded normal values from numpy, on ``device`` in ``dtype``."""
    import numpy as np
    import torch

    x = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    return x.to(device=device, dtype=dtype or dtype_for(device))


def time_call(fn, *args, repeats: int = 5, warmup: int = 2) -> float:
    """Best-of-N wall-clock seconds for fn(*args), each call ending in a
    synchronize of its output's device (host staging plus device time).
    The warmup calls take a kernel library's first build."""
    for _ in range(warmup):
        synchronize(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        synchronize(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    """One CSV line per benchmark result: name,us_per_call,derived."""
    print(f"{name},{us_per_call:.2f},{derived}", flush=True)


def card_line(device) -> str:
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line for a
    CUDA device, ``"cpu"`` for the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
