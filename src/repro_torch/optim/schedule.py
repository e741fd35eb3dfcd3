"""LR schedules."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to min_ratio * base_lr, in f32 as
    the reference computes it; a 0-d f32 tensor on the CPU."""
    s = torch.as_tensor(float(step), dtype=torch.float32)
    warm = base_lr * (s + 1.0) / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1.0 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)
