"""Device and circuit non-ideality models (paper Section IV), as in
`repro/core/nonideal.py`.

1. Conductance variation: each programmed conductance deviates from its
   target by additive Gaussian noise (sigma = 0.05 * G0 in the paper).
2. Interconnect (wire) resistance: the first-order effective-conductance
   model (O(n^2), used at all sizes).

Geometry convention: the input drive enters at row 0 of each bit-line,
the sensing amplifier sits past the last column of each word-line.

Every function here takes a (..., r, c) stack: one physical array per
trailing 2-D slice.  Matrix products broadcast over the leading axes, so
no explicit map over tiles is needed.

Noise comes from an explicit `torch.Generator`.  It is drawn on the
generator's device and then moved to the conductances' device, so one
seed gives the same conductances on the host and on the card.

Not in this module yet (they raise NotImplementedError): the exact
"nodal" wire model, nodal write-verify and stuck-at faults, which belong
to the physics layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


# ---------------------------------------------------------------------------
# Conductance variation
# ---------------------------------------------------------------------------

def apply_variation(g: torch.Tensor, generator: torch.Generator,
                    sigma_g: float) -> torch.Tensor:
    """Additive Gaussian conductance noise, clipped at zero (physical)."""
    if sigma_g == 0.0:
        return g
    noise = torch.randn(g.shape, generator=generator, dtype=g.dtype,
                        device=generator.device).to(g.device)
    return torch.clamp_min(g + sigma_g * noise, 0.0)


# ---------------------------------------------------------------------------
# First-order interconnect-resistance model
# ---------------------------------------------------------------------------

def _segment_kernels(n_rows: int, n_cols: int, like: torch.Tensor):
    """Shared-segment counts C[i, i'] = 1 + min(i, i') (bit lines) and
    S[j, j'] = n_c - max(j, j') (word lines)."""
    i = torch.arange(n_rows, dtype=like.dtype, device=like.device)
    j = torch.arange(n_cols, dtype=like.dtype, device=like.device)
    c_bl = 1.0 + torch.minimum(i[:, None], i[None, :])
    s_wl = n_cols - torch.maximum(j[:, None], j[None, :])
    return c_bl, s_wl


def effective_conductance(g: torch.Tensor, r_seg) -> torch.Tensor:
    """First-order (in r*G) effective conductance of a wired crossbar:

      G_eff = G - r * [ G .* (C @ G) + G .* (G @ S) ]

    with the segment-count kernels of `_segment_kernels`.  `r_seg` may be
    a tensor (the model is linear in it); only a Python zero short-cuts.
    """
    if isinstance(r_seg, (int, float)) and r_seg == 0.0:
        return g
    c_bl, s_wl = _segment_kernels(g.shape[-2], g.shape[-1], g)
    drop = g * (c_bl @ g) + g * (g @ s_wl)
    return g - r_seg * drop


def compensate_conductances(g_target: torch.Tensor, r_seg: float,
                            iters: int = 3) -> torch.Tensor:
    """Write-verify compensation for wire IR drop: fixed-point iteration
    G <- max(G_target + r * drop(G), 0) so that G_eff(G) ~ G_target."""
    if r_seg == 0.0:
        return g_target
    c_bl, s_wl = _segment_kernels(g_target.shape[-2], g_target.shape[-1],
                                  g_target)
    g = g_target
    for _ in range(iters):
        drop = g * (c_bl @ g) + g * (g @ s_wl)
        g = torch.clamp_min(g_target + r_seg * drop, 0.0)
    return g


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NonidealConfig:
    """Knobs for the analog non-ideality models (paper Section IV).

    The same fields as the reference's config: it is hashed into
    `plan_signature`, so every field combination is its own packing key.
    """
    sigma: float = 0.0        # conductance sigma in units of G0 (paper: 0.05)
    r_wire: float = 0.0       # wire segment resistance in ohms (paper: 1.0)
    wire_model: str = "first_order"   # "first_order" | "nodal" | "none"
    compensate_wire: bool = False     # write-verify IR-drop compensation
    compensate_model: Optional[str] = None  # None -> wire_model
    wv_iters: int = 3                 # write-verify fixed-point iterations
    drift_t: float = 0.0              # readout time since programming [s]
    drift_nu: float = 0.0             # power-law drift exponent (0 = off)
    p_stuck_on: float = 0.0           # fraction of devices stuck at G_on
    p_stuck_off: float = 0.0          # fraction of devices stuck at G_off
    g_stuck_on: float = 1.0           # stuck-ON conductance, units of G0
    g_stuck_off: float = 0.0          # stuck-OFF conductance, units of G0
    remap_faults: bool = False        # fault-aware row/column remapping

    VARIATION_PAPER = 0.05
    R_WIRE_PAPER = 1.0


IDEAL = NonidealConfig()
PAPER_VARIATION = NonidealConfig(sigma=0.05)
PAPER_FULL = NonidealConfig(sigma=0.05, r_wire=1.0)


# ---------------------------------------------------------------------------
# Shared programming / readout pipeline
#
#   program_conductances : target -> device state (write-verify, noise)
#   readout_conductance + wire_readout : device state -> the matrix the
#                          circuit computes with (drift, then wire model)
# ---------------------------------------------------------------------------

def _physics_slice(what: str):
    return NotImplementedError(
        f"{what} belongs to the physics layer, which repro_torch does not "
        f"port yet")


def program_conductances(g_target: torch.Tensor, generator: torch.Generator,
                         ni: NonidealConfig, g0: float) -> torch.Tensor:
    """The one programming pipeline: write-verify, then write noise.

    `g_target` is a (..., r, c) stack of target conductances.  Noise is
    drawn from `generator` independently per device.
    """
    g = g_target
    if ni.compensate_wire and ni.r_wire > 0.0:
        model = ni.compensate_model or ni.wire_model
        if model == "first_order":
            g = compensate_conductances(g, ni.r_wire, ni.wv_iters)
        elif model == "nodal":
            raise _physics_slice("nodal write-verify")
        elif model != "none":
            raise ValueError(f"unknown compensate_model: {model!r}")
    if ni.p_stuck_on > 0.0 or ni.p_stuck_off > 0.0:
        raise _physics_slice("stuck-at faults")
    return apply_variation(g, generator, ni.sigma * g0)


def readout_conductance(g: torch.Tensor, ni: NonidealConfig,
                        drift_t=None) -> torch.Tensor:
    """Device state at readout time: power-law retention drift
    G(t) = G(t0) * (t/t0)^-nu with t0 = 1 s.

    `drift_t` optionally overrides the config age: a scalar ages the whole
    stack, a vector of leading-axis extent ages each tile on its own.
    Ages below t0 clamp to 1; `drift_nu == 0` disables drift.
    """
    if drift_t is not None:
        if ni.drift_nu == 0.0:
            return g
        t = torch.clamp_min(torch.as_tensor(drift_t, dtype=g.dtype,
                                            device=g.device), 1.0)
        factor = t ** -ni.drift_nu
        if factor.ndim:
            factor = factor.reshape(
                factor.shape + (1,) * (g.ndim - factor.ndim))
        return g * factor
    if ni.drift_nu == 0.0 or ni.drift_t <= 0.0 or ni.drift_t == 1.0:
        return g
    return g * (ni.drift_t ** (-ni.drift_nu))


def wire_readout(g: torch.Tensor, ni: NonidealConfig,
                 r_wire=None) -> torch.Tensor:
    """Apply the configured wire model over a (..., r, c) stack.

    `r_wire` optionally overrides `ni.r_wire` and always routes through the
    first-order model.
    """
    if r_wire is not None:
        return effective_conductance(g, r_wire)
    if ni.r_wire <= 0.0 or ni.wire_model == "none":
        return g
    if ni.wire_model == "first_order":
        return effective_conductance(g, ni.r_wire)
    if ni.wire_model == "nodal":
        raise _physics_slice("the nodal wire model")
    raise ValueError(f"unknown wire_model: {ni.wire_model!r}")
