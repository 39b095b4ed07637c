"""Learning-rate schedules (the port of the reference's ``optim/schedule.py``):
float32 arithmetic on the step, a tensor on the optimizer's device."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "linear_warmup_cosine"]


def cosine_schedule(step: torch.Tensor, *, base_lr: float, total_steps: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    frac = torch.clamp(step.float() / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return base_lr * (min_ratio + (1.0 - min_ratio) * cos)


def linear_warmup_cosine(step: torch.Tensor, *, base_lr: float, warmup_steps: int,
                         total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    step_f = step.float()
    warm = step_f / max(warmup_steps, 1)
    after = cosine_schedule(step - warmup_steps,
                            base_lr=base_lr,
                            total_steps=max(total_steps - warmup_steps, 1),
                            min_ratio=min_ratio)
    return torch.where(step_f < warmup_steps, base_lr * warm, after)
