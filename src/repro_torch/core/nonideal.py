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

The physics layer (`repro_torch.physics`) plugs in here: the exact
"nodal" wire model at readout, nodal write-verify and stuck-at faults at
programming time.  It is imported where it is used, as in the reference.
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
#   program_conductances : target -> device state (write-verify, noise,
#                          stuck-at faults)
#   readout_conductance + wire_readout : device state -> the matrix the
#                          circuit computes with (drift, then wire model)
# ---------------------------------------------------------------------------

def write_verified(g_target: torch.Tensor, ni: NonidealConfig,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """The deterministic part of programming: the write-verify
    pre-distortion of a (..., r, c) target stack against the configured
    compensation model (the targets themselves when it is off).  The nodal
    model reads the whole stack with one batched readout per round, its
    sweeps picked by `use_kernel` (`wire_readout`'s convention)."""
    if not (ni.compensate_wire and ni.r_wire > 0.0):
        return g_target
    model = ni.compensate_model or ni.wire_model
    if model == "first_order":
        return compensate_conductances(g_target, ni.r_wire, ni.wv_iters)
    if model == "nodal":
        from repro_torch.physics import dynamics as _dyn
        return _dyn.write_verify(g_target, ni.r_wire, model="nodal",
                                 iters=ni.wv_iters, use_kernel=use_kernel)
    if model != "none":
        raise ValueError(f"unknown compensate_model: {model!r}")
    return g_target


def _has_faults(ni: NonidealConfig) -> bool:
    return ni.p_stuck_on > 0.0 or ni.p_stuck_off > 0.0


def device_draws(shape, generator: torch.Generator, ni: NonidealConfig,
                 dtype: torch.dtype):
    """The random numbers of one programmed stack, in the documented
    order: the variation normals (sigma > 0), then the stuck-at uniforms
    (faults on); None for a draw that is off.  Drawn on the generator's
    device."""
    normal = uniform = None
    if ni.sigma != 0.0:
        normal = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                             device=generator.device)
    if _has_faults(ni):
        uniform = torch.rand(tuple(shape), generator=generator,
                             device=generator.device)
    return normal, uniform


def apply_device_draws(g: torch.Tensor, g_target: torch.Tensor, normal,
                       uniform, ni: NonidealConfig, g0: float
                       ) -> torch.Tensor:
    """Write noise (clipped at zero), then stuck-at faults stamped after
    it, from draws made by `device_draws` (moved to g's device)."""
    if normal is not None:
        g = torch.clamp_min(g + (ni.sigma * g0) * normal.to(g.device), 0.0)
    if uniform is not None:
        from repro_torch.physics import faults as _faults
        on, off = _faults.stuck_masks(uniform.to(g.device), ni.p_stuck_on,
                                      ni.p_stuck_off)
        g = _faults.apply_stuck_masks(
            g, g_target, on, off, g_on=ni.g_stuck_on * g0,
            g_off=ni.g_stuck_off * g0, remap=ni.remap_faults)
    return g


def program_conductances(g_target: torch.Tensor, generator: torch.Generator,
                         ni: NonidealConfig, g0: float,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """The one programming pipeline: write-verify, then write noise, then
    stuck-at faults.

    `g_target` is a (..., r, c) stack of target conductances.  The stack's
    variation normals are drawn from `generator` first, then its fault
    uniforms, one per device each (the reference splits its key into a
    variation key and a fault key instead).  `use_kernel` is
    `write_verified`'s.
    """
    g = write_verified(g_target, ni, use_kernel)
    normal, uniform = device_draws(g.shape, generator, ni, g.dtype)
    return apply_device_draws(g, g_target, normal, uniform, ni, g0)


def readout_conductance(g: torch.Tensor, ni: NonidealConfig,
                        drift_t=None) -> torch.Tensor:
    """Device state at readout time: power-law retention drift
    G(t) = G(t0) * (t/t0)^-nu with t0 = 1 s.

    `drift_t` optionally overrides the config age: a scalar ages the whole
    stack, a (num,) vector ages each array of a (..., num, r, c) stack on
    its own (it lines up with the array axis -3, so a Monte-Carlo axis or
    the pair's [gpos, gneg] axis in front is broadcast).  Ages below t0
    clamp to 1; `drift_nu == 0` disables drift.
    """
    if drift_t is not None:
        if ni.drift_nu == 0.0:
            return g
        t = torch.clamp_min(torch.as_tensor(drift_t, dtype=g.dtype,
                                            device=g.device), 1.0)
        factor = t ** -ni.drift_nu
        if factor.ndim:
            factor = factor.reshape(factor.shape + (1, 1))
        return g * factor
    if ni.drift_nu == 0.0 or ni.drift_t <= 0.0 or ni.drift_t == 1.0:
        return g
    return g * (ni.drift_t ** (-ni.drift_nu))


def wire_readout(g: torch.Tensor, ni: NonidealConfig, r_wire=None,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Apply the configured wire model over a (..., r, c) stack.

    The nodal model reads the whole stack with one batched nodal readout
    over its flattened leading axes (in chunks that keep a chunk's Minv
    stack at `physics.nodal.READOUT_CHUNK_BYTES`); on the card its sweeps
    run in the block-Thomas kernel, unless `use_kernel=False` asks for the
    plain version (`physics.nodal` convention).  `r_wire` optionally
    overrides `ni.r_wire` and always routes through the first-order model.
    """
    if r_wire is not None:
        return effective_conductance(g, r_wire)
    if ni.r_wire <= 0.0 or ni.wire_model == "none":
        return g
    if ni.wire_model == "first_order":
        return effective_conductance(g, ni.r_wire)
    if ni.wire_model == "nodal":
        from repro_torch.physics import dynamics as _dyn
        return _dyn.nodal_readout(g, ni.r_wire, use_kernel=use_kernel)
    raise ValueError(f"unknown wire_model: {ni.wire_model!r}")
