"""Device and circuit non-ideality models (paper Section IV), as in
`repro/core/nonideal.py`.

1. Conductance variation: each programmed conductance deviates from its
   target by additive Gaussian noise (sigma = 0.05 * G0 in the paper).
2. Interconnect (wire) resistance: the first-order effective-conductance
   model (O(n^2), used at all sizes), and the exact dense MNA solvers in
   float64 (`mna_mvm_currents`, `mna_inv_outputs`: O(n^6), small n), the
   ground truth the nodal solver and the first-order model are held to.

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

import numpy as np
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


# ---------------------------------------------------------------------------
# Exact MNA crossbar solvers (validation oracles, small n; HSPICE stand-in)
# ---------------------------------------------------------------------------
#
# Node layout for an (nr x nc) crossbar with wire segments:
#   BL node b(i,j): on bit-line (column) j at row i       -> index i*nc + j
#   WL node w(i,j): on word-line (row) i at column j      -> index nr*nc + i*nc + j
# Cell (i,j) connects b(i,j) <-> w(i,j) with conductance g[i,j].
# BL segments connect b(i-1,j) <-> b(i,j); the driver feeds b(0,j) through
# one segment.  WL segments connect w(i,j) <-> w(i,j+1); the sense node is
# one segment past w(i, nc-1) and is held at virtual ground.
#
# Everything is float64 whatever the input's dtype.  A tensor `g` keeps
# its device (the card's dense solve); anything else goes to the host.
# The stamps are the reference's, in its order, with `index_put_(...,
# accumulate=True)` for `np.add.at`: within one stamp every index is
# distinct, so on the host L, drive and sense equal the reference's bit
# for bit.  The solve is `torch.linalg.solve`, the oracle's own
# definition.

def _f64(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def _crossbar_laplacian(g, r_seg: float):
    """The (2*nr*nc) x (2*nr*nc) conductance Laplacian plus the
    driver (2*nr*nc, nc) and sense (2*nr*nc, nr) coupling matrices,
    dense float64 on g's device (validation oracle only)."""
    dev = g.device if isinstance(g, torch.Tensor) else torch.device("cpu")
    g = _f64(g, dev)
    nr, nc = g.shape
    n_nodes = 2 * nr * nc
    gw = 1.0 / r_seg

    bl = (torch.arange(nr, device=dev)[:, None] * nc
          + torch.arange(nc, device=dev)[None, :])
    wl = nr * nc + bl

    L = torch.zeros((n_nodes, n_nodes), dtype=torch.float64, device=dev)

    def stamp(a_idx, b_idx, cond):
        cond = torch.as_tensor(cond, dtype=torch.float64, device=dev)
        cond = cond.expand(a_idx.shape).reshape(-1)
        a_idx, b_idx = a_idx.reshape(-1), b_idx.reshape(-1)
        L.index_put_((a_idx, a_idx), cond, accumulate=True)
        L.index_put_((b_idx, b_idx), cond, accumulate=True)
        L.index_put_((a_idx, b_idx), -cond, accumulate=True)
        L.index_put_((b_idx, a_idx), -cond, accumulate=True)

    stamp(bl, wl, g)                         # cells
    stamp(bl[:-1, :], bl[1:, :], gw)         # BL wire segments (vertical)
    stamp(wl[:, :-1], wl[:, 1:], gw)         # WL wire segments (horizontal)
    # Driver coupling: v_in[j] -> b(0,j) through one BL segment.
    cols = torch.arange(nc, device=dev)
    drive = torch.zeros((n_nodes, nc), dtype=torch.float64, device=dev)
    L.index_put_((bl[0, :], bl[0, :]),
                 torch.full((nc,), gw, dtype=torch.float64, device=dev),
                 accumulate=True)
    drive[bl[0, :], cols] = gw
    # Sense coupling: w(i, nc-1) -> virtual ground through one WL segment.
    rows = torch.arange(nr, device=dev)
    sense = torch.zeros((n_nodes, nr), dtype=torch.float64, device=dev)
    L.index_put_((wl[:, -1], wl[:, -1]),
                 torch.full((nr,), gw, dtype=torch.float64, device=dev),
                 accumulate=True)
    sense[wl[:, -1], rows] = gw
    return L, drive, sense


def mna_mvm_currents(g, v_in, r_seg: float) -> torch.Tensor:
    """Exact sense currents of the MVM crossbar (TIA inputs at 0 V), a
    float64 tensor on g's device: I[i], the current into the virtual
    ground of row i, for v_in (nc,) or (nc, k).  Ideal limit
    (r_seg -> 0): I = g @ v_in."""
    L, drive, sense = _crossbar_laplacian(g, r_seg)
    v_in = _f64(v_in, L.device)
    # KCL at all internal nodes: L v = drive @ v_in   (sense nodes at 0 V are
    # already folded into L's diagonal via the sense coupling).
    v = torch.linalg.solve(L, drive @ v_in)
    # Current into each virtual ground = gw * v(w(i, nc-1)).
    return sense.T @ v


def mna_inv_outputs(g, v_in, r_seg: float, g0: float) -> torch.Tensor:
    """Exact OPA output voltages of the INV circuit with wire resistance,
    a float64 tensor on g's device.

    Circuit (paper Fig. 1b): v_in[i] injected through a G0 resistor into
    word line i's summing node; OPA i senses that node (ideal virtual
    ground) and drives bit line i, so that G0 v_in + G_eff v_out = 0.
    Unknowns: the internal node voltages v (2*nr*nc) and the OPA outputs
    u (nc).  Equations: KCL at every internal node, L v - drive @ u = 0,
    and a summing node at 0 V drawing no input current a row,
    (sense.T @ v)[i] + g0 * v_in[i] = 0.
    """
    nr, nc = g.shape
    assert nr == nc, "INV circuit requires a square array"
    L, drive, sense = _crossbar_laplacian(g, r_seg)
    v_in = _f64(v_in, L.device)
    n_nodes = 2 * nr * nc
    top = torch.cat([L, -drive], dim=1)
    bot = torch.cat([sense.T, torch.zeros((nr, nc), dtype=torch.float64,
                                          device=L.device)], dim=1)
    M = torch.cat([top, bot], dim=0)
    rhs = torch.cat([torch.zeros((n_nodes,), dtype=torch.float64,
                                 device=L.device), -g0 * v_in])
    sol = torch.linalg.solve(M, rhs)
    return sol[n_nodes:]


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
