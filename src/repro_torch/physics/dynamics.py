"""Device dynamics: retention drift and write-verify programming loops, as
in `repro/physics/dynamics.py`.

* Retention drift: programmed conductances relax as G(t) = G(t0) *
  (t/t0)^-nu (t0 = 1 s), applied at readout time.
* Write-verify: iterative target tracking - measure the effective matrix
  the circuit computes with through a wire model, nudge the programmed
  conductances by the residual, repeat:

      g <- clip(g + damping * (g_target - H_model(g)), 0, g_max).

  model="first_order" tracks the O(n^2) perturbation model; model="nodal"
  tracks the exact nodal solve, which is what a hardware loop measuring
  real sense currents does.

Both take (..., r, c) stacks; the nodal write-verify reads a whole stack
with one batched nodal readout per round.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.nonideal import effective_conductance
from repro_torch.physics.nodal import (nodal_effective_conductance_batched,
                                       readout_chunk)


def drift_conductance(g: torch.Tensor, t: float, nu: float,
                      t0: float = 1.0) -> torch.Tensor:
    """Power-law retention drift G(t) = G(t0) * (t/t0)^-nu; t <= 0 or
    nu == 0 is the identity."""
    if nu == 0.0 or t <= 0.0:
        return g
    return g * float((t / t0) ** (-nu))


def drift_traced(g: torch.Tensor, age, nu: float) -> torch.Tensor:
    """`drift_conductance` for a tensor age: a scalar, or a vector aging
    each array of the leading axes.  Ages clamp to >= 1 (a device is never
    younger than freshly programmed; t0 = 1)."""
    if nu == 0.0:
        return g
    t = torch.clamp_min(torch.as_tensor(age, dtype=g.dtype,
                                        device=g.device), 1.0)
    factor = t ** -nu
    if factor.ndim:
        factor = factor.reshape(factor.shape + (1,) * (g.ndim - factor.ndim))
    return g * factor


def nodal_readout(g: torch.Tensor, r_seg: float,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Exact effective conductance of every array of a (..., r, c) stack:
    one batched nodal readout over the flattened leading axes, in chunks
    of `nodal.readout_chunk` crossbars."""
    r, c = g.shape[-2:]
    flat = g.reshape((-1, r, c))
    h = nodal_effective_conductance_batched(
        flat, r_seg, chunk=readout_chunk(r, c, g.dtype),
        use_kernel=use_kernel)
    return h.reshape(g.shape)


def write_verify(g_target: torch.Tensor, r_seg: float, *,
                 model: str = "nodal", iters: int = 5,
                 damping: float = 1.0,
                 g_max: Optional[float] = None,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Iterative write-verify of a (..., r, c) target stack against a wire
    model; returns the programmed conductances (non-negative, optionally
    capped at g_max).  Deterministic: the verify step reads the model.
    `use_kernel` picks the nodal readouts' sweeps (`nodal_readout`)."""
    if r_seg == 0.0:
        return g_target
    if model == "first_order":
        heff = lambda g: effective_conductance(g, r_seg)          # noqa: E731
    elif model == "nodal":
        heff = lambda g: nodal_readout(g, r_seg, use_kernel)      # noqa: E731
    else:
        raise ValueError(f"unknown write-verify model: {model!r}")
    g = g_target
    for _ in range(iters):
        g = g + damping * (g_target - heff(g))
        g = torch.clamp_min(g, 0.0) if g_max is None \
            else torch.clamp(g, 0.0, g_max)
    return g
