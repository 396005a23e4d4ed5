"""Bottom-up hardware-aware candidate generation (paper §5.1, Algorithm 2).

For each rKernel layer, from the innermost out:

  1. ``init_cands``        — seed the candidate range from that layer's
     hardware resource limits (paper ``InitCands``/``GetHardwareInfo``) and
     the *workload's* per-tile footprint model (workloads.py).
  2. ``filter_by_isa``     — at layer 0, keep only tiles compatible with the
     ISA granularity (MMA/AVX512 in the paper; wgmma/warp tiles on the
     H100, MXU/VREG tiling on the TPU).
  3. ``filter_by_multiples`` — keep only tiles that are elementwise integer
     multiples of at least one surviving lower-layer tile (the sieve), and
     record the child map.  This confines padding loss to the outermost
     runtime level (paper Fig. 8).

The generator is workload-generic: every capacity check routes through the
:class:`~repro_torch.core.workloads.Workload` protocol, so attention reuses
Algorithm 2 unchanged.  The output is a :class:`CandidateLattice`: per-layer
candidate lists plus the parent→children map the analyzer scores.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Sequence

from repro_torch.core.hardware import HardwareLevel, HardwareSpec
from repro_torch.core.workloads import Workload

__all__ = [
    "Tile",
    "CandidateLattice",
    "init_cands",
    "filter_by_isa",
    "filter_by_multiples",
    "generate_lattice",
]

Tile = tuple[int, int, int]  # (m, n, k)


@dataclasses.dataclass(frozen=True)
class CandidateLattice:
    """All surviving candidates, per layer, innermost first.

    ``children[d]`` maps a layer-d tile to the layer-(d-1) tiles it is a
    multiple of (Algorithm 2's ``map``); ``children[0]`` is empty.
    """

    backend: str
    layers: tuple[tuple[Tile, ...], ...]
    children: tuple[Mapping[Tile, tuple[Tile, ...]], ...]

    @property
    def l0(self) -> tuple[Tile, ...]:
        return self.layers[0]

    @property
    def l1(self) -> tuple[Tile, ...]:
        return self.layers[1]

    def num_candidates(self) -> int:
        return sum(len(layer) for layer in self.layers)


def _pow2_range(lo: int, hi: int) -> list[int]:
    out = []
    v = lo
    while v <= hi:
        out.append(v)
        v *= 2
    return out


def init_cands(
    level: HardwareLevel, wl: Workload, backend_tile: Tile
) -> list[Tile]:
    """Seed candidates for one layer from hardware limits (``InitCands``).

    The enumeration is powers-of-two multiples of the backend's native tile,
    bounded above by the layer's storage capacity against the workload's
    footprint model — exactly the paper's "deduce a feasible range for
    candidate shapes based on hardware utilization metrics" step.
    Power-of-two steps keep the multiples sieve dense without exploding the
    space (the paper reports 392 candidates for the tensor-core GEMM space;
    ours is the same order of magnitude).
    """
    bm, bn, bk = backend_tile
    if level.depth == 0:
        # Level-0 range: from 1x the native tile up to the register-file
        # capacity (operand fragments must fit the VREG file).
        mm, mn, mk = wl.l0_axis_multipliers()
        ms = _pow2_range(bm, bm * mm)
        ns = _pow2_range(bn, bn * mn)
        ks = _pow2_range(bk, bk * mk)
        cap = level.capacity_bytes
        out = []
        for t in itertools.product(ms, ns, ks):
            if cap is None or wl.l0_fragment_bytes(t) <= cap * 16:
                # VREG fragments are pipelined; allow a 16x over-subscription
                # factor (operands stream through, not resident all at once).
                out.append(t)
        return out
    # Upper layers: bounded by this layer's memory capacity.
    cm, cn, ck = wl.l1_axis_caps(backend_tile)
    ms = _pow2_range(bm, max(cm, bm))
    ns = _pow2_range(bn, max(cn, bn))
    ks = _pow2_range(bk, max(ck, bk))
    out = []
    for t in itertools.product(ms, ns, ks):
        if level.capacity_bytes is None or (
            wl.l1_tile_bytes(t) <= level.capacity_bytes
        ):
            out.append(t)
    return out


def filter_by_isa(
    cands: Sequence[Tile], hw: HardwareSpec, backend: str
) -> list[Tile]:
    """Layer-0 ISA-compatibility filter (``FilterByISA``).

    Every level-0 dim must be a multiple of the backend's native tile: the
    wgmma m64 x n8 x k16 shape on the H100 tensor cores, the 128-lane MXU
    tiling on the TPU — the paper's MMA-shape / AVX512-width constraints.
    """
    bm, bn, bk = hw.native_tile[backend]
    return [
        (m, n, k)
        for (m, n, k) in cands
        if m % bm == 0 and n % bn == 0 and k % bk == 0
    ]


def filter_by_multiples(
    cands: Sequence[Tile], prev_cands: Sequence[Tile]
) -> tuple[list[Tile], dict[Tile, tuple[Tile, ...]]]:
    """Multiples sieve (``FilterByMultiples``): keep layer-L tiles that are
    elementwise integer multiples of >=1 layer-(L-1) tile; return the map
    from each survivor to its compatible children (Algorithm 2's table).
    """
    child_map: dict[Tile, list[Tile]] = {}
    cand_set = set(cands)
    # Sieve direction follows the paper: iterate *previous-layer* candidates
    # and generate their multiples inside the current layer's range, rather
    # than testing every (cand, prev) pair.
    for prev in prev_cands:
        pm, pn, pk = prev
        for cand in cand_set:
            m, n, k = cand
            if m % pm == 0 and n % pn == 0 and k % pk == 0:
                child_map.setdefault(cand, []).append(prev)
    filtered = sorted(child_map)
    return filtered, {t: tuple(cs) for t, cs in child_map.items()}


def generate_lattice(
    hw: HardwareSpec, wl: Workload, backend: str | None = None
) -> CandidateLattice:
    """Run Algorithm 2 bottom-up across all strategy layers.

    Only layers 0 and 1 carry tile candidates (level 2, the grid, is fully
    determined by the runtime shape and the layer-1 tile); this matches the
    paper's GPU setting where grid geometry is computed at kernel
    construction time (§6.2).
    """
    backend = backend or hw.default_backend
    native = hw.native_tile[backend]

    l0 = init_cands(hw.level(0), wl, native)
    l0 = filter_by_isa(l0, hw, backend)
    if not l0:
        raise ValueError(f"no level-0 candidates for backend {backend!r}")

    l1 = init_cands(hw.level(1), wl, native)
    l1, child_map = filter_by_multiples(l1, l0)
    if not l1:
        raise ValueError("no level-1 candidates survived the sieve")

    return CandidateLattice(
        backend=backend,
        layers=(tuple(l0), tuple(l1)),
        children=({}, child_map),
    )
