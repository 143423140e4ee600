"""LR schedules, as `repro/optim/schedule.py`."""
from __future__ import annotations

import math

import torch

from repro_torch.numerics import over


def warmup_cosine(step, *, warmup: int = 200, total: int = 10000,
                  floor: float = 0.1) -> torch.Tensor:
    """Relative LR multiplier: linear warmup then cosine to `floor`.

    `step` is a Python int or a tensor (the result is a float32 0-d or
    shaped tensor on its device).  The divisions are by device tensors
    (`numerics.over`), as the reference divides by arrays.
    """
    step = torch.as_tensor(step).to(torch.float32)
    warm = over(step + 1.0, max(warmup, 1))
    frac = torch.clamp(over(step - warmup, max(total - warmup, 1)), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, cos)
