"""Three-term roofline of one step from its counted costs (counterpart of
src/repro/roofline/analysis.py):

    compute term    = per-device FLOPs / peak FLOP/s
    memory term     = per-device HBM bytes / HBM bandwidth
    collective term = per-device collective bytes / interconnect bandwidth

The reference parses its costs from the compiled HLO; here they come from
the ops the step dispatches (:mod:`repro_torch.roofline.op_counts`), so
:func:`roofline_report` takes a :class:`ModuleCosts` where the reference
takes ``hlo_text``.  ``raw_cost_analysis`` holds what XLA's
``cost_analysis()`` gave beside the parse; the port has no such second
count, and a caller may pass its own.  MODEL_FLOPS is 6·N·D for training
(N active parameters, D tokens) and 2·N·D for inference.

``V5E`` is the reference's default chip and stays the default, so the two
packages' reports compare field for field.  ``H100_SXM`` is the port's
card, from the NVIDIA H100 data sheet (SXM5): 989 TFLOP/s dense bf16 on
the tensor cores, 3.35 TB/s of HBM3, 80 GB (taken as 80e9 bytes).  Its
``ici_bw`` is NVLink 4's aggregate in one direction: 18 links of 25 GB/s
each way, 450 GB/s (the data sheet's 900 GB/s counts both directions).
The reference's ``ici_bw`` is one ICI link of the TPU; a GPU's collectives
run over all of its NVLink links through the NVSwitch, so the aggregate
is the figure that bounds them.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.roofline.op_counts import ModuleCosts

__all__ = ["ChipSpec", "V5E", "H100_SXM", "RooflineReport",
           "roofline_report", "model_flops"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float       # bf16
    hbm_bw: float           # bytes/s
    ici_bw: float           # bytes/s (see the module docstring per chip)
    hbm_bytes: float


V5E = ChipSpec(
    name="tpu_v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    hbm_bytes=16 * 1024**3,
)

H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    hbm_bytes=80e9,
)


def model_flops(
    cfg: ModelConfig, shape: ShapeSpec, params: int, active_params: int
) -> float:
    """Useful model FLOPs for the whole step (all chips)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active_params * tokens
    # decode: one token per sequence
    return 2.0 * active_params * shape.global_batch


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device
    flops: float
    memory_bytes: float
    collective_bytes: float
    # terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_total: float
    useful_ratio: float       # MODEL_FLOPS / (per-dev flops * chips)
    mfu_bound: float          # compute-bound time / min step time
    collective_by_kind: Mapping[str, float]
    raw_cost_analysis: Mapping[str, float]
    trip_counts: Mapping[str, int] = dataclasses.field(default_factory=dict)
    note: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_report(
    *,
    arch: str,
    shape: ShapeSpec,
    mesh_name: str,
    chips: int,
    costs: ModuleCosts,
    cost_analysis: Mapping[str, float] | None,
    cfg: ModelConfig,
    params: int,
    active_params: int,
    chip: ChipSpec = V5E,
    note: str = "",
) -> RooflineReport:
    compute_s = costs.flops / chip.peak_flops
    memory_s = costs.memory_bytes / chip.hbm_bw
    collective_s = costs.collective_bytes / chip.ici_bw
    terms = {
        "compute": compute_s, "memory": memory_s, "collective": collective_s
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, params, active_params)
    total = costs.flops * chips
    useful = mf / total if total else 0.0
    bound = max(terms.values())
    mfu_bound = compute_s / bound if bound else 0.0
    raw = {
        k: float(v) for k, v in dict(cost_analysis or {}).items()
        if isinstance(v, (int, float)) and k in (
            "flops", "bytes accessed", "transcendentals",
            "bytes accessed output", "optimal_seconds",
        )
    }
    return RooflineReport(
        arch=arch,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        flops=costs.flops,
        memory_bytes=costs.memory_bytes,
        collective_bytes=costs.collective_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops_total=mf,
        useful_ratio=useful,
        mfu_bound=mfu_bound,
        collective_by_kind=dict(costs.collective_by_kind),
        raw_cost_analysis=raw,
        trip_counts=dict(costs.while_trip_counts),
        note=note,
    )
