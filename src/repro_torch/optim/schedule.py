"""LR schedules (port of ``repro.optim.schedule``): pure functions of
the int step, a [] integer tensor, computed in float32."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step: torch.Tensor, *, peak_lr: float,
                    warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = peak_lr * s / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)
