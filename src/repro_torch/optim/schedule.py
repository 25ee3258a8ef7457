"""LR schedules: linear warmup + cosine decay (the default for examples).

Counterpart of the reference's ``repro.optim.schedule``: ``step`` may be
a Python number (the result is a float) or a tensor (the result is a
float32 tensor on its device)."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_ratio: float = 0.1):
    if isinstance(step, torch.Tensor):
        s = step.to(torch.float32)
        warm = peak_lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_ratio + (1 - final_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, peak_lr * cos)
    # float32 arithmetic, as the reference's jnp computes it
    s = torch.tensor(float(step), dtype=torch.float32)
    return float(warmup_cosine(s, peak_lr=peak_lr, warmup_steps=warmup_steps,
                               total_steps=total_steps,
                               final_ratio=final_ratio))
