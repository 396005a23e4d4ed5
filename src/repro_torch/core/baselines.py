"""Baselines the paper compares against (§7.1), rebuilt for the port
(counterpart of src/repro/core/baselines.py).

* :class:`SampleDrivenCompiler` — a DietCode/Nimble-style compiler: it tunes
  micro-kernels *per shape sample* by empirical search (real wall-clock on
  the configured device), then at runtime routes any shape to the nearest
  sample's micro-kernel with padding.  Off-sample shapes pay the padding
  penalty the paper demonstrates in Fig. 3 / Table 6.
* :class:`VendorBaseline` — the vendor library: ``torch.matmul`` at the
  *exact* runtime shape (cuBLAS on the card).  It is a baseline, never a
  path of the port.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.candidates import generate_lattice
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.timing import synchronize
from repro_torch.core.workloads import GemmWorkload
from repro_torch.device import resolve_device

__all__ = ["SampleDrivenCompiler", "VendorBaseline"]


@dataclasses.dataclass
class _TunedKernel:
    sample_m: int
    tile_m: int  # the micro-kernel's M tile; runtime M pads up to multiples
    best_us: float


class SampleDrivenCompiler:
    """Sample-driven dynamic-shape compilation (DietCode-like).

    Offline: for every M sample, *empirically* search M-tile candidates by
    timing the padded matmul on the device (``torch.matmul`` at the padded
    shape, host wall-clock around a synchronized call) — the costly
    auto-tuning loop whose overhead the paper's §7.4 contrasts with
    Vortex's sample-free seconds.  ``search_budget`` bounds timed configs
    per sample.

    Runtime: a nearest-sample selector picks the micro-kernel whose sample
    M is closest above the runtime M (else the largest sample), then pads M
    to that kernel's static shape.  ``device`` is the card unless the
    caller asks for the CPU; ``dtype`` is the operands' type.
    """

    def __init__(
        self,
        hw: HardwareSpec,
        wl: GemmWorkload,
        samples: Sequence[int],
        search_budget: int = 8,
        repeats: int = 3,
        *,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        if not samples:
            raise ValueError("sample-driven compilation requires samples")
        self._wl = wl
        self._device = resolve_device(device)
        self._samples = sorted(set(samples))
        t0 = time.perf_counter()
        tile_space = sorted(
            {t[0] for t in generate_lattice(hw, wl, hw.default_backend).l1}
        )[:search_budget]
        self._kernels: list[_TunedKernel] = []
        b = torch.zeros((wl.K, wl.N), dtype=dtype, device=self._device)
        for s in self._samples:
            best = (float("inf"), tile_space[0])
            for tm in tile_space:
                mp = math.ceil(s / tm) * tm
                a = torch.zeros((mp, wl.K), dtype=dtype, device=self._device)
                synchronize(torch.matmul(a, b))  # untimed first call
                t_best = float("inf")
                for _ in range(repeats):
                    t1 = time.perf_counter()
                    synchronize(torch.matmul(a, b))
                    t_best = min(t_best, time.perf_counter() - t1)
                if t_best < best[0]:
                    best = (t_best, tm)
            self._kernels.append(
                _TunedKernel(sample_m=s, tile_m=best[1], best_us=best[0] * 1e6)
            )
        self.tuning_seconds = time.perf_counter() - t0

    def _route(self, m: int) -> _TunedKernel:
        for kern in self._kernels:  # samples sorted ascending
            if kern.sample_m >= m:
                return kern
        return self._kernels[-1]

    def padded_m(self, m: int) -> int:
        """DietCode semantics: micro-kernels are compiled per *sample*, so a
        runtime M is padded up to the nearest sample's M.  Beyond the
        largest sample, pad to that sample's tile granularity (the
        off-sample penalty of the paper's Fig. 3 / Table 6)."""
        kern = self._route(m)
        if m <= kern.sample_m:
            return kern.sample_m
        return math.ceil(m / kern.tile_m) * kern.tile_m

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        m = a.shape[0]
        mp = self.padded_m(m)
        if mp != m:
            a = F.pad(a, (0, 0, 0, mp - m))
        out = torch.matmul(a, b)
        return out[:m] if mp != m else out


class VendorBaseline:
    """``torch.matmul`` at the exact runtime shape (cuBLAS on the card)."""

    def __init__(self, wl: GemmWorkload):
        self._wl = wl

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(a, b)
