"""Public kernel entry points, with the dtype policies of
`repro/kernels/ops.py`: the arena program computes in f32 and returns the
arena's dtype; the block-Thomas sweeps keep their input dtype, float64
included.

A tensor on the CPU runs the plain version (`ref.py`); a tensor on the
card launches the hand-written kernel, or raises - there is no fallback
for CUDA tensors.  The CUDA kernels mask their own edges (the rhs axis K,
the block size s), so nothing is padded; arena offsets and tile dims are
positions and are never padded either.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import arena_mvm as _arena
from repro_torch.kernels import banded_solve as _banded
from repro_torch.kernels import ref as _ref


def arena_packed_apply(arena, ops, in_offs, in_signs, out_offs, out_init, *,
                       dac_bits=None, adc_bits=None, fullscale: float = 1.0):
    """Run a whole packed tile program (see `kernels/arena_mvm.py`).

    arena (M, S, K), ops (M, T, R, C), window metadata (T, ...) shared by
    the instances.  Returns the updated arena in the arena's dtype.  On the
    card an f32 contiguous arena is updated in place (and returned); use
    the return value either way.
    """
    kw = dict(dac_bits=dac_bits, adc_bits=adc_bits, fullscale=fullscale)
    if arena.device.type == "cpu":
        out = _ref.arena_packed_ref(arena, ops, in_offs, in_signs, out_offs,
                                    out_init, **kw)
        return out.to(arena.dtype)
    if arena.device.type != "cuda":
        raise ValueError(f"no arena kernel for device {arena.device}")
    dev = arena.device
    out = arena.to(torch.float32).contiguous()
    _arena.arena_packed_apply(
        out, ops.to(torch.float32).contiguous(),
        in_offs.to(device=dev, dtype=torch.int32).contiguous(),
        in_signs.to(device=dev, dtype=torch.float32).contiguous(),
        out_offs.to(device=dev, dtype=torch.int32).contiguous(),
        out_init.to(device=dev, dtype=torch.int32).contiguous(), **kw)
    return out.to(arena.dtype)


def arena_level_apply(arena, ops, in_offs, in_signs, out_offs, out_init, *,
                      dac_bits=None, adc_bits=None, fullscale: float = 1.0):
    """One arena level group: arena (S, K), ops (L, R, C); the M=1 case of
    `arena_packed_apply`, through the same kernel."""
    return arena_packed_apply(arena[None], ops[None], in_offs, in_signs,
                              out_offs, out_init, dac_bits=dac_bits,
                              adc_bits=adc_bits, fullscale=fullscale)[0]


def block_tridiag_solve(minv, rhs, *, gw: float):
    """Batched block-Thomas sweeps over precomputed inverse factors (see
    `kernels/banded_solve.py`): minv (B, nr, s, s), rhs (B, nr, s, k) ->
    (B, nr, s, k) in the common dtype of the two, float32 or float64 (any
    other raises, on the host as on the card)."""
    dtype = torch.promote_types(minv.dtype, rhs.dtype)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"block-Thomas sweeps take float32 or float64, "
                         f"got {dtype}")
    if rhs.device.type == "cpu":
        return _ref.block_tridiag_solve_ref(minv.to(dtype), rhs.to(dtype),
                                            gw=gw)
    if rhs.device.type != "cuda":
        raise ValueError(f"no block-Thomas kernel for device {rhs.device}")
    return _banded.block_tridiag_solve(
        minv.to(device=rhs.device, dtype=dtype).contiguous(),
        rhs.to(dtype).contiguous(), gw=gw)
