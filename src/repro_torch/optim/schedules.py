"""Learning-rate schedules: functions of the step tensor, as the
reference's ``repro/optim/schedules.py``, computed in float32 on the step's
device."""
from __future__ import annotations

import math

import torch


def linear_warmup(peak: float, warmup_steps: int):
    def f(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        return peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
    return f


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.1):
    def f(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak * warm * cos
    return f
