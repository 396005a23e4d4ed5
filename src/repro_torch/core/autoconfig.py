"""Vortex-driven framework auto-configuration (counterpart of
src/repro/core/autoconfig.py).

The paper selects GEMM micro-kernel tiles from a hardware-pruned lattice.
The same machinery configures two framework-level knobs, sample-free:

* :func:`select_attn_chunk`: the flash-attention KV-chunk length, the
  N-extent of the QK^T tile; candidates come from the Vortex level-1
  lattice and are scored with the Eq. 2 pipeline model (per-chunk load vs
  compute plus a per-iteration overhead).
* :func:`select_microbatches`: the gradient-accumulation factor, the
  smallest power-of-two count whose per-device transient working set
  (logits block, MoE dispatch buffers, residual) fits the activation
  budget.

Both keep the reference's behaviour at every spec, ``TPU_V5E`` being the
default.  At ``H100_SXM`` two things follow from it:

* level 1 is the 232,448-byte shared-memory cap, so ``vmem_frac=0.25``
  leaves 58,112 bytes; at ``head_dim=128`` the K and V tiles of a
  128-row chunk alone take 65,536, so no candidate of 128 or more fits
  whatever ``q_rows`` is, and the function falls through to
  ``min(1024, seq)``;
* ``select_microbatches`` ignores ``hw``: its budget is a fixed 16 GiB
  times ``hbm_activation_frac``.
"""
from __future__ import annotations

import math

from repro_torch.core.candidates import generate_lattice
from repro_torch.core.hardware import TPU_V5E, HardwareSpec
from repro_torch.core.workloads import GemmWorkload

__all__ = ["select_attn_chunk", "select_microbatches"]

_SCAN_OVERHEAD_S = 2e-6  # per scan-iteration dispatch overhead (fixed cost)


def select_attn_chunk(
    seq: int,
    head_dim: int,
    q_rows: int,
    *,
    hw: HardwareSpec = TPU_V5E,
    dtype_bytes: int = 2,
    vmem_frac: float = 0.25,
) -> int:
    """Pick the flash-attention KV-chunk from the Vortex lattice.

    Eq. 2 shape: per chunk, T_load = chunk*(head_dim*2 + q_rows)*bytes/HBM
    (K,V tiles + score block), body = 2*q_rows*chunk*head_dim*2 / peak
    (QK^T and PV), pipelined; plus a fixed per-iteration overhead that
    penalizes tiny chunks.  Bounded above by the level-1 working set.
    """
    wl = GemmWorkload(M=None, N=256, K=max(head_dim, 128))
    lattice = generate_lattice(hw, wl, hw.default_backend)
    cands = sorted({t[2] for t in lattice.l1})  # k-extent candidates
    vmem = (hw.level(1).capacity_bytes or 1 << 27) * vmem_frac
    hbm = hw.level(1).load_bandwidth
    peak = hw.backends[hw.default_backend]

    best, best_cost = None, float("inf")
    for c in cands:
        if c < 128 or c > seq:
            continue
        # K,V chunk + f32 score block resident per step.
        ws = 2 * c * head_dim * dtype_bytes + q_rows * c * 4
        if ws > vmem:
            continue
        n_iter = math.ceil(seq / c)
        t_load = c * (2 * head_dim + q_rows) * dtype_bytes / hbm
        body = 2 * 2 * q_rows * c * head_dim / peak
        per = max(t_load, body) + _SCAN_OVERHEAD_S
        cost = n_iter * per
        if cost < best_cost:
            best, best_cost = c, cost
    return best or min(1024, seq)


def select_microbatches(
    *,
    global_batch: int,
    seq: int,
    d_model: int,
    vocab: int,
    n_data_shards: int,
    n_model_shards: int,
    moe_experts: int = 0,
    moe_topk: int = 0,
    capacity_factor: float = 1.25,
    hw: HardwareSpec = TPU_V5E,
    hbm_activation_frac: float = 0.25,
) -> int:
    """Smallest power-of-two microbatch count whose transient per-device
    working set fits the activation share of HBM (paper InitCands logic at
    the framework level).  ``hw`` is accepted and unused, as in the
    reference: the budget is 16 GiB times ``hbm_activation_frac``."""
    budget = 16 * 2**30 * hbm_activation_frac
    mb = 1
    while mb < global_batch:
        b_loc = max(global_batch // mb // max(n_data_shards, 1), 1)
        logits = b_loc * seq * math.ceil(vocab / max(n_model_shards, 1)) * 4
        ws = logits + b_loc * seq * d_model * 2 * 4  # residual + f32 temp
        if moe_experts:
            cap = math.ceil(seq * moe_topk * capacity_factor / moe_experts)
            e_loc = math.ceil(moe_experts / max(n_model_shards, 1))
            ws += b_loc * e_loc * cap * d_model * 2 * 3
        if ws <= budget:
            return mb
        mb *= 2
    return mb
