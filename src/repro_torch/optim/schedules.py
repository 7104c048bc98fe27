"""Learning-rate schedules (counterpart of repro/optim/schedules.py):
functions of the step (an int or an int tensor) returning the rate as a
float32 tensor on the step's device, in the reference's arithmetic."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step):
        s = _f32(step)
        return peak * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
    return fn


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def fn(step):
        s = _f32(step)
        warm = peak * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, peak * cos)
    return fn
