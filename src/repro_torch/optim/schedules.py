"""Learning-rate schedules of the reference (``repro.optim.schedules``),
in f32: each takes the optimizer's integer step tensor and returns a 0-d
f32 tensor on its device."""

from __future__ import annotations

import math

import torch

f32 = torch.float32


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=f32, device=step.device)


def cosine_decay(peak: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(step.to(f32) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return peak * (final_frac + (1 - final_frac) * cos)

    return fn


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        s = step.to(f32)
        warm = peak * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (final_frac + (1 - final_frac) * 0.5
                      * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)

    return fn
