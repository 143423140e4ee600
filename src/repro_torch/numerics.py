"""Division as the reference divides.

`jnp` divides by an array: an IEEE division, rounded once.  PyTorch's
CUDA division by a host number multiplies by its reciprocal instead,
which rounds twice and can move a result by one ulp - enough to flip an
int8 code or a bias correction against the reference.  `over` divides by
a 0-d tensor on the dividend's device, which CUDA divides exactly.
"""
from __future__ import annotations

import torch


def over(x: torch.Tensor, d) -> torch.Tensor:
    """x / d, with d (a host number or a 0-d tensor) carried to x's dtype
    and device first."""
    return x / torch.as_tensor(d, dtype=x.dtype, device=x.device)
