"""Public kernel entry points, with the dtype policy of
`repro/kernels/ops.py`: compute in f32, return the arena's dtype.

A tensor on the CPU runs the plain version (`ref.py`); a tensor on the
card launches the hand-written kernel, or raises - there is no fallback
for CUDA tensors.  The CUDA kernel masks its own edge of the rhs axis K,
so nothing is padded; arena offsets and tile dims are positions and are
never padded either.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import arena_mvm as _arena
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
