"""Learning-rate schedules (pure functions of the step counter), in fp32 as
the JAX package computes them."""
from __future__ import annotations

import math

import torch


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def cosine_with_warmup(
    base_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1
):
    def schedule(step):
        step = _f32(step)
        warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0,
            1.0,
        )
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return base_lr * warm * (min_ratio + (1 - min_ratio) * cos)

    return schedule


def linear_with_warmup(base_lr: float, warmup_steps: int, total_steps: int):
    def schedule(step):
        step = _f32(step)
        warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
        decay = torch.clamp(
            1.0 - (step - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0,
            1.0,
        )
        return base_lr * warm * decay

    return schedule
