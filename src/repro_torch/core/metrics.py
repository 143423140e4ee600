"""Accuracy metrics of the paper's evaluation (Eq. 6), as in
`repro/core/metrics.py`.  Reductions run over the last axis."""
from __future__ import annotations

import torch


def relative_error(x_ideal: torch.Tensor,
                   x_actual: torch.Tensor) -> torch.Tensor:
    """Paper Eq. (6): sum_i |x_i - xhat_i| / sum_i |x_i| (an L1/L1 ratio)."""
    num = torch.sum(torch.abs(x_ideal - x_actual), dim=-1)
    den = torch.sum(torch.abs(x_ideal), dim=-1)
    return torch.abs(num / den)


def l2_relative_error(x_ideal: torch.Tensor,
                      x_actual: torch.Tensor) -> torch.Tensor:
    """||x - xhat|| / ||x||, reported alongside the paper metric."""
    num = torch.linalg.vector_norm(x_ideal - x_actual, dim=-1)
    den = torch.linalg.vector_norm(x_ideal, dim=-1)
    return num / den
