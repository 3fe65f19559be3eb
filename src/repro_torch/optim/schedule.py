"""LR schedules.  Port of ``repro.optim.schedule``."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warmup → cosine decay to ``floor``·peak.  ``lr(step)`` takes
    an int or a tensor and returns a 0-d fp32 tensor (on the step's
    device)."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        t = torch.clamp(t, 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr
