"""Learning-rate schedules, pure functions of the step count
(counterpart of src/repro/optim/schedule.py), in float32 on the step's
device."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "linear_warmup_cosine"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).float()


def cosine_schedule(
    step, base_lr: float, total_steps: int, min_frac: float = 0.1
) -> torch.Tensor:
    t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return base_lr * (min_frac + (1.0 - min_frac) * cos)


def linear_warmup_cosine(
    step,
    base_lr: float,
    warmup_steps: int,
    total_steps: int,
    min_frac: float = 0.1,
) -> torch.Tensor:
    step = torch.as_tensor(step)
    warm = base_lr * torch.clamp(
        (_f32(step) + 1.0) / max(warmup_steps, 1), max=1.0)
    cos = cosine_schedule(
        step - warmup_steps, base_lr, max(total_steps - warmup_steps, 1),
        min_frac,
    )
    return torch.where(step < warmup_steps, warm, cos)
