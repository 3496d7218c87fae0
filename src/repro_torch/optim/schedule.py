"""LR schedules: the port of ``repro/optim/schedule.py`` (warmup-cosine),
in fp32 on the device, as JAX computes it."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, base_lr: float, warmup: int = 100,
                  total: int = 10_000, min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    down to ``min_frac * base_lr`` at ``total``. ``step`` is a tensor (its
    device is the result's); the arithmetic is fp32."""
    step = step.to(torch.float32)
    warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, base_lr * cos)
