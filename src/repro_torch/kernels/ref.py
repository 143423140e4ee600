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


def crossbar_mvm_ref(v, gpos, gneg, *, g0, dac_bits=None, adc_bits=None,
                     fullscale=1.0):
    """Plain version of the differential crossbar MVM:
    out[b, r] = ADC(-(sum_c (gpos - gneg)[r, c] * DAC(v[b, c])) / g0).

    v (B, C), gpos/gneg (R, C) -> (B, R) float32.  v is widened before the
    DAC; the difference is taken in the conductances' dtype, then widened.
    Divides by g0, as the reference's oracle does (the kernel multiplies by
    a float32 1/g0), through a tensor so no backend swaps in a reciprocal.
    """
    vq = quantize(v.to(torch.float32), dac_bits, fullscale)
    g = (gpos - gneg).to(torch.float32)
    out = -(vq @ g.T) / torch.full((), g0, dtype=torch.float32,
                                   device=vq.device)
    return quantize(out, adc_bits, fullscale)


def crossbar_mvm_batched_ref(v, gpos, gneg, *, g0, dac_bits=None,
                             adc_bits=None, fullscale=1.0):
    """Plain version of the crossbar MVM over a stack of L arrays, as one
    batched product: v (L, B, C), gpos/gneg (L, R, C) -> (L, B, R)."""
    vq = quantize(v.to(torch.float32), dac_bits, fullscale)
    g = (gpos - gneg).to(torch.float32)
    out = -torch.bmm(vq, g.transpose(1, 2)) / torch.full(
        (), g0, dtype=torch.float32, device=vq.device)
    return quantize(out, adc_bits, fullscale)


def schur_update_ref(a4, a3, w):
    """Plain version of the fused Schur update: A4 - A3 @ W in float32."""
    return a4.to(torch.float32) - a3.to(torch.float32) @ w.to(torch.float32)


def flash_attention_ref(q, k, v, *, causal=True):
    """Plain softmax attention.  q, k, v: (BH, S, D) -> (BH, S, D).

    As the reference oracle: scores in the inputs' dtype scaled by
    D**-0.5, masked to -1e30 above the diagonal when causal, softmax in
    float32 cast back to q's dtype, then the weighted sum of v.  The
    kernel's own function (float32 throughout, cast at the end) is this
    evaluated on float32 copies of the inputs.
    """
    s = torch.einsum("bqd,bkd->bqk", q, k) * (q.shape[-1] ** -0.5)
    if causal:
        n = q.shape[1]
        above = torch.ones((n, n), dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, -1e30)
    w = torch.softmax(s.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bqk,bkd->bqd", w, v)
