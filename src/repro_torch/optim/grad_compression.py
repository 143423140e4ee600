"""Gradient compression: int8 quantisation with error feedback, as
`repro/optim/grad_compression.py`.

At multi-pod scale the reference reduces gradients hierarchically: full
precision within a pod, an int8-compressed sum across pods, with
per-tensor scales and an error-feedback residual so that compression
noise does not accumulate.  This module holds the quantiser, its inverse
and the residual's initial state.  The reference's `compressed_psum`
sums across a named mesh axis; it comes with the port's mesh (ROADMAP.md
queue 1, the mesh slice).

The divisions are by device tensors (`numerics.over`), as `jnp` divides
by an array.  `torch.round` rounds half to even, as `jnp.round` does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.numerics import over
from repro_torch.tree import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = over(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(tree: Any) -> Any:
    """Zero float32 residuals shaped as the leaves of `tree`."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), tree)
