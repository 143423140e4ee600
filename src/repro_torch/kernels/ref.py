"""Plain PyTorch versions of the hand-written kernels: the ground truth the
kernels are held against, and what the wrappers run for CPU tensors.  The
counterparts of `repro/kernels/ref.py`."""
from __future__ import annotations

import torch

from repro_torch.core.quantization import quantize


def arena_packed_ref(arena, ops, in_offs, in_signs, out_offs, out_init, *,
                     dac_bits=None, adc_bits=None, fullscale=1.0):
    """Plain version of the instance-packed arena tile program.

    arena (M, S, K), ops (M, T, R, C), metadata (T, J) / (T,) shared by all
    instances.  For each tile t in order, on every instance at once:
    signed whole-window gather, DAC, operator apply, ADC, then write
    (out_init 1) or add (0) into the output window.  Computes in f32 and
    returns a new arena.
    """
    arena = arena.to(torch.float32).clone()
    ops = ops.to(torch.float32)
    rows, cols = ops.shape[-2:]
    offs, signs = in_offs.tolist(), in_signs.tolist()
    outs, init = out_offs.tolist(), out_init.tolist()
    for t in range(ops.shape[1]):
        v = torch.zeros(arena.shape[:1] + (cols,) + arena.shape[2:],
                        dtype=torch.float32, device=arena.device)
        for off, sign in zip(offs[t], signs[t]):
            v = v + sign * arena[:, off:off + cols]
        v = quantize(v, dac_bits, fullscale)
        out = quantize(ops[:, t] @ v, adc_bits, fullscale)
        o = outs[t]
        if init[t]:
            arena[:, o:o + rows] = out
        else:
            arena[:, o:o + rows] += out
    return arena


def arena_level_ref(arena, ops, in_offs, in_signs, out_offs, out_init, *,
                    dac_bits=None, adc_bits=None, fullscale=1.0):
    """Plain version of one arena level group: arena (S, K), ops (L, R, C);
    the M=1 case of `arena_packed_ref`."""
    return arena_packed_ref(arena[None], ops[None], in_offs, in_signs,
                            out_offs, out_init, dac_bits=dac_bits,
                            adc_bits=adc_bits, fullscale=fullscale)[0]


def block_tridiag_solve_ref(minv, rhs, *, gw):
    """Plain version of the batched block-Thomas sweeps: a Python loop over
    the nr block rows, the batch vectorised; keeps the input dtype.

    minv (B, nr, s, s), rhs (B, nr, s, k) -> (B, nr, s, k), with
    z_i = Minv_i (rhs_i + gw z_{i-1}) forward and
    x_i = z_i + gw Minv_i x_{i+1} backward (z_{-1} = x_{nr} = 0).
    """
    nr = rhs.shape[1]
    z = torch.zeros_like(rhs[:, 0])
    zs = []
    for i in range(nr):
        z = minv[:, i] @ (rhs[:, i] + gw * z)
        zs.append(z)
    x = torch.zeros_like(z)
    xs = [None] * nr
    for i in reversed(range(nr)):
        x = zs[i] + gw * (minv[:, i] @ x)
        xs[i] = x
    return torch.stack(xs, dim=1)
