"""Roofline analysis: per-device costs counted from the dispatched ops,
the three roofline terms, and analytic per-device memory (counterpart of
src/repro/roofline/)."""
from repro_torch.roofline.analysis import (
    H100_SXM,
    V5E,
    ChipSpec,
    RooflineReport,
    model_flops,
    roofline_report,
)
from repro_torch.roofline.memory import fits_hbm, tree_device_bytes
from repro_torch.roofline.op_counts import ModuleCosts, OpCounter, count_costs

__all__ = [
    "ChipSpec",
    "H100_SXM",
    "ModuleCosts",
    "OpCounter",
    "RooflineReport",
    "V5E",
    "count_costs",
    "fits_hbm",
    "model_flops",
    "roofline_report",
    "tree_device_bytes",
]
