"""Behavioural models of the in-memory AMC circuits (paper Section II), as in
`repro/core/analog.py`.

  MVM circuit (Fig. 1a):  v_out = -(G / G0) @ v_in
  INV circuit (Fig. 1b):  v_out = -(G / G0)^-1 @ v_in

Both carry the minus sign of the negative-feedback amplifiers.  A signed
matrix is normalised so its largest |element| is 1, then split A = A+ - A-
onto two differential arrays of unit conductance G0, each with its own
device noise.

Random draws: `map_matrix` draws the positive array's noise first, then
the negative array's; `map_tiled` maps its tiles row-major;
`map_tiled_vec` draws its whole positive stack, then its whole negative
stack; `map_matrix_sliced` draws slice by slice, positive before negative.
One `torch.Generator` is consumed in that order.  Given a sequence of
generators instead - one per Monte-Carlo simulation, the counterpart of
the reference's `vmap` over keys - the programmed pairs carry a leading
simulation axis (S, r, c), each simulation draws from its own generator in
that same order, and the deterministic write-verify runs once for all.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import torch

from repro_torch.core import nonideal
from repro_torch.core.nonideal import NonidealConfig
from repro_torch.core.quantization import quantize

G0_PAPER = 100e-6  # unit conductance, 100 uS


@dataclasses.dataclass(frozen=True)
class AnalogConfig:
    """Static configuration of the AMC substrate (same fields as the
    reference's `AnalogConfig`)."""
    g0: float = G0_PAPER
    array_size: int = 256          # max rows/cols of one physical array
    nonideal: NonidealConfig = nonideal.IDEAL
    dac_bits: Optional[int] = None  # None = ideal interface
    adc_bits: Optional[int] = None
    v_fullscale: float = 1.0        # converter full-scale (normalised units)
    opa_gain: Optional[float] = None  # OPA open-loop gain; None = ideal OPA

    def with_(self, **kw) -> "AnalogConfig":
        return dataclasses.replace(self, **kw)


IDEAL_CFG = AnalogConfig()


def _a_eff(gpos, gneg, g0, cfg: AnalogConfig, r_wire=None, drift_t=None,
           use_kernel=None):
    """The one readout pipeline: drift on the device state, then the wire
    model, then the differential matrix in units of G0.  Both arrays of
    the pair go through one wire-model call (one nodal readout);
    `use_kernel` is `nonideal.wire_readout`'s."""
    ni = cfg.nonideal
    g = nonideal.wire_readout(
        nonideal.readout_conductance(torch.stack([gpos, gneg]), ni,
                                     drift_t=drift_t),
        ni, r_wire=r_wire, use_kernel=use_kernel)
    return (g[0] - g[1]) / g0


@dataclasses.dataclass
class CrossbarPair:
    """A signed matrix block programmed on two differential arrays.

    `gpos`/`gneg` are conductances in Siemens after programming noise,
    (r, c) or, for a Monte-Carlo batch, (S, r, c); `shape` is the array's
    (r, c).  `scale` is the solver-global normalisation 1/max|A|.
    """
    gpos: torch.Tensor
    gneg: torch.Tensor
    scale: torch.Tensor
    g0: float

    @property
    def shape(self):
        return tuple(self.gpos.shape[-2:])

    def a_eff(self, cfg: AnalogConfig, r_wire=None, drift_t=None,
              use_kernel=None) -> torch.Tensor:
        """The matrix the circuit computes with (drift, then wire model)."""
        return _a_eff(self.gpos, self.gneg, self.g0, cfg, r_wire, drift_t,
                      use_kernel)


Generators = Union[torch.Generator, Sequence[torch.Generator]]


def map_matrix(a_block: torch.Tensor, generator: Generators,
               cfg: AnalogConfig, scale: torch.Tensor,
               use_kernel=None) -> CrossbarPair:
    """Program one signed block onto a differential crossbar pair.

    The pair's two target arrays are write-verified together (one call of
    the compensation model); then each generator draws the positive
    array's noise and the negative array's (`nonideal.program_conductances`
    order).  A sequence of generators gives an (S, r, c) pair.
    `use_kernel` is `nonideal.write_verified`'s.
    """
    single = isinstance(generator, torch.Generator)
    gens = [generator] if single else list(generator)
    dtype = torch.result_type(a_block, scale)
    draws = [pair_draws(a_block.shape, gen, cfg.nonideal, dtype)
             for gen in gens]
    pair = map_matrix_drawn(a_block, draws, cfg, scale, use_kernel)
    if single:
        pair = CrossbarPair(pair.gpos[0], pair.gneg[0], scale, cfg.g0)
    return pair


def pair_draws(shape, generator: torch.Generator, ni, dtype):
    """The random numbers of one programmed pair from `generator`: the
    positive array's `nonideal.device_draws`, then the negative one's."""
    return [nonideal.device_draws(shape, generator, ni, dtype)
            for _ in range(2)]


def map_matrix_drawn(a_block: torch.Tensor, draws, cfg: AnalogConfig,
                     scale: torch.Tensor, use_kernel=None) -> CrossbarPair:
    """`map_matrix` from draws made already: `draws` holds one
    `pair_draws` per simulation, and the pair is (S, r, c)."""
    ni = cfg.nonideal
    a_norm = a_block * scale
    targets = torch.stack([torch.clamp_min(a_norm, 0.0) * cfg.g0,
                           torch.clamp_min(-a_norm, 0.0) * cfg.g0])
    written = nonideal.write_verified(targets, ni, use_kernel)
    lead = (len(draws),) + tuple(targets.shape)
    normal, uniform = (None if parts[0] is None
                       else torch.stack(parts).reshape(lead)
                       for parts in zip(*(d for pair in draws
                                          for d in pair)))
    g = nonideal.apply_device_draws(written.expand(lead),
                                    targets.expand(lead), normal, uniform,
                                    ni, cfg.g0)
    return CrossbarPair(g[..., 0, :, :], g[..., 1, :, :], scale, cfg.g0)


# ---------------------------------------------------------------------------
# Converter interfaces
# ---------------------------------------------------------------------------

def dac(v: torch.Tensor, cfg: AnalogConfig) -> torch.Tensor:
    return quantize(v, cfg.dac_bits, cfg.v_fullscale)


def adc(v: torch.Tensor, cfg: AnalogConfig) -> torch.Tensor:
    return quantize(v, cfg.adc_bits, cfg.v_fullscale)


# ---------------------------------------------------------------------------
# Circuit primitives (signed, faithful to Fig. 1)
# ---------------------------------------------------------------------------

def _row_load(pair: CrossbarPair, cfg: AnalogConfig) -> torch.Tensor:
    """Total physical conductance on each row summing node (both arrays)."""
    return cfg.g0 + torch.sum(pair.gpos + pair.gneg, dim=-1)


def _per_row(load: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-row quantity against a vector or (rows, k) matrix."""
    return load[:, None] if out.ndim == 2 else load


def amc_mvm(pair: CrossbarPair, v_in: torch.Tensor,
            cfg: AnalogConfig) -> torch.Tensor:
    """MVM circuit: v_out = -A_eff @ v_in; `v_in` is (cols,) or (cols, k).

    With finite OPA open-loop gain the output is divided by
    1 + (G0 + sum_j G_ij) / (A_ol G0) per row.
    """
    out = -(pair.a_eff(cfg) @ v_in)
    if cfg.opa_gain is not None:
        load = _row_load(pair, cfg)
        out = out / (1.0 + _per_row(load, out) / (cfg.opa_gain * cfg.g0))
    return out


def amc_inv(pair: CrossbarPair, v_in: torch.Tensor,
            cfg: AnalogConfig) -> torch.Tensor:
    """INV circuit equilibrium: v_out = -A_eff^-1 v_in (solved digitally).

    With finite OPA gain the summing-node loading adds diag(load)/A_ol.
    """
    a = pair.a_eff(cfg)
    if cfg.opa_gain is not None:
        load = _row_load(pair, cfg) / (cfg.opa_gain * cfg.g0)
        a = a + torch.diag(load)
    return -torch.linalg.solve(a, v_in)


# ---------------------------------------------------------------------------
# Bit-sliced mapping (ISAAC-style; beyond-paper precision extension)
# ---------------------------------------------------------------------------

def map_matrix_sliced(a_block: torch.Tensor, generator: torch.Generator,
                      cfg: AnalogConfig, scale: torch.Tensor,
                      n_slices: int = 2, bits_per_slice: int = 4):
    """Map one signed block as `n_slices` arrays of `bits_per_slice` each.

    Each slice stores a quantised digit of the target conductance at full
    dynamic range (re-normalised to G0), so the per-device absolute noise
    sigma*G0 is divided by the slice weight on recombination.  Returns a
    list of (CrossbarPair, weight); `amc_mvm_sliced` recombines digitally.
    Each slice draws its positive array's noise, then its negative one's.
    """
    a_norm = a_block * scale
    levels = 2 ** bits_per_slice
    pairs = []
    residual_pos = torch.clamp_min(a_norm, 0.0)
    residual_neg = torch.clamp_min(-a_norm, 0.0)
    sigma_g = cfg.nonideal.sigma * cfg.g0
    for s in range(n_slices):
        weight = float(levels) ** (-s)
        # digit in [0, 1): quantise the residual at this significance
        dig_p = torch.floor(torch.clamp(residual_pos / weight, 0, 1 - 1e-9)
                            * levels) / levels
        dig_n = torch.floor(torch.clamp(residual_neg / weight, 0, 1 - 1e-9)
                            * levels) / levels
        residual_pos = residual_pos - dig_p * weight
        residual_neg = residual_neg - dig_n * weight
        gpos = nonideal.apply_variation(dig_p * cfg.g0, generator, sigma_g)
        gneg = nonideal.apply_variation(dig_n * cfg.g0, generator, sigma_g)
        pairs.append((CrossbarPair(gpos, gneg, scale, cfg.g0), weight))
    return pairs


def amc_mvm_sliced(pairs, v_in: torch.Tensor,
                   cfg: AnalogConfig) -> torch.Tensor:
    """MVM over bit-sliced arrays; digital shift-add recombination."""
    out = None
    for pair, weight in pairs:
        part = amc_mvm(pair, v_in, cfg) * weight
        out = part if out is None else out + part
    return out


# ---------------------------------------------------------------------------
# Partitioned MVM for blocks larger than one physical array
# ---------------------------------------------------------------------------

def map_tiled(a: torch.Tensor, generator: Generators, cfg: AnalogConfig,
              scale: torch.Tensor,
              use_kernel=None) -> List[List[CrossbarPair]]:
    """Map an (R x C) matrix onto a grid of <= array_size tiles, row-major.
    R and C need not be multiples of the array size."""
    s = cfg.array_size
    rows, cols = a.shape
    grid = []
    for r0 in range(0, rows, s):
        grid.append([map_matrix(a[r0:r0 + s, c0:c0 + s], generator, cfg,
                                scale, use_kernel)
                     for c0 in range(0, cols, s)])
    return grid


def amc_mvm_tiled(grid, v_in: torch.Tensor, cfg: AnalogConfig) -> torch.Tensor:
    """Partitioned MVM: partial products per tile column, summed per tile
    row (analog current summing); the tiles of one tile-row share the row
    TIAs, so the finite-gain load is the whole tile-row's."""
    out_rows = []
    for row in grid:
        col_off = 0
        acc = None
        load = cfg.g0
        for pair in row:
            c = pair.shape[1]
            part = -(pair.a_eff(cfg) @ v_in[col_off:col_off + c])
            acc = part if acc is None else acc + part
            load = load + torch.sum(pair.gpos + pair.gneg, dim=1)
            col_off += c
        if cfg.opa_gain is not None:
            acc = acc / (1.0 + _per_row(load, acc) / (cfg.opa_gain * cfg.g0))
        out_rows.append(acc)
    return torch.cat(out_rows)


# ---------------------------------------------------------------------------
# Stacked-tile form
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TileGrid:
    """A stacked differential crossbar tile tensor: (..., rows, cols).

    The leading axes are batch/tile axes; the trailing two are one
    physical array.
    """
    gpos: torch.Tensor
    gneg: torch.Tensor
    scale: torch.Tensor
    g0: float

    @property
    def shape(self):
        return tuple(self.gpos.shape)

    def a_eff(self, cfg: AnalogConfig, r_wire=None, drift_t=None,
              use_kernel=None) -> torch.Tensor:
        return _a_eff(self.gpos, self.gneg, self.g0, cfg, r_wire, drift_t,
                      use_kernel)

    def pair(self, idx) -> CrossbarPair:
        """View one entry of the leading axis as a CrossbarPair."""
        return CrossbarPair(self.gpos[idx], self.gneg[idx], self.scale,
                            self.g0)

    def tile(self, idx) -> CrossbarPair:
        """View tile `idx` of the tile axis (-3) as a CrossbarPair; a
        Monte-Carlo axis in front of it stays on the pair."""
        return CrossbarPair(self.gpos[..., idx, :, :],
                            self.gneg[..., idx, :, :], self.scale, self.g0)


def stack_pairs(pairs, scale, g0) -> TileGrid:
    """Stack same-shape CrossbarPairs into a (..., num, r, c) TileGrid (the
    tile axis is -3: a simulation axis of the pairs stays in front)."""
    return TileGrid(torch.stack([p.gpos for p in pairs], dim=-3),
                    torch.stack([p.gneg for p in pairs], dim=-3), scale, g0)


def map_tiled_vec(a: torch.Tensor, generator: torch.Generator,
                  cfg: AnalogConfig, scale: torch.Tensor) -> TileGrid:
    """Map an (R x C) matrix onto an (rt, ct, s, s) tile tensor.

    R and C must be multiples of cfg.array_size (`map_tiled` handles
    ragged shapes).  Leading axes of `a` stay in front of the tile axes: a
    (nb, R, C) stack of blocks maps to (nb, rt, ct, s, s) in one call.
    Runs the shared programming pipeline: the two target stacks are
    write-verified together (`nonideal.write_verified`), then `generator`
    draws the whole positive stack's noise and the whole negative stack's,
    each in `nonideal.device_draws` order.
    """
    s = cfg.array_size
    rows, cols = a.shape[-2:]
    if rows % s or cols % s:
        raise ValueError(f"map_tiled_vec needs multiples of the array size "
                         f"{s}, got {(rows, cols)}")
    rt, ct = rows // s, cols // s
    lead = tuple(a.shape[:-2])
    tiles = a.reshape(lead + (rt, s, ct, s)).transpose(-3, -2)
    a_norm = tiles * scale
    targets = torch.stack([torch.clamp_min(a_norm, 0.0) * cfg.g0,
                           torch.clamp_min(-a_norm, 0.0) * cfg.g0])
    ni = cfg.nonideal
    written = nonideal.write_verified(targets, ni)
    g = [nonideal.apply_device_draws(
        written[i], targets[i],
        *nonideal.device_draws(targets.shape[1:], generator, ni,
                               targets.dtype), ni, cfg.g0)
         for i in range(2)]                       # positive, negative
    return TileGrid(g[0], g[1], scale, cfg.g0)
