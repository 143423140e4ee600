"""The uniform converter quantiser (DAC/ADC model), as in
`repro/core/quantization.py`.

A mid-rise quantiser over [-fullscale, +fullscale] with clipping.  The
rounding step is piecewise constant, so `quantize` carries a straight-
through estimator: the backward pass lets the gradient through inside the
full-scale range and zeroes it where the input was clipped.  The forward
value is the plain computation.

The sequence is clip, divide by `step`, round half to even, multiply by
`step`; `step` is a tensor on the input's device so that no backend turns
the division into a multiplication by a reciprocal (PyTorch's CUDA
division by a host scalar does).  The CUDA arena kernel quantises with the
same sequence (`kernels/csrc/arena_mvm.cu`).
"""
from __future__ import annotations

from typing import Optional

import torch


def quantizer_step(bits: int, fullscale: float) -> float:
    """The converter's step, computed in double like the reference's
    Python-float arithmetic, then rounded once to the working type."""
    return 2.0 * fullscale / (2 ** bits - 1)


class _QuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, bits, fullscale):
        ctx.save_for_backward(v)
        ctx.fullscale = fullscale
        step = torch.full((), quantizer_step(bits, fullscale),
                          dtype=v.dtype, device=v.device)
        v = torch.clamp(v, -fullscale, fullscale)
        return torch.round(v / step) * step

    @staticmethod
    def backward(ctx, grad):
        (v,) = ctx.saved_tensors
        inside = (v.abs() <= ctx.fullscale).to(grad.dtype)
        return grad * inside, None, None


def quantize(v: torch.Tensor, bits: Optional[int],
             fullscale: float) -> torch.Tensor:
    """Uniform mid-rise quantiser over [-fullscale, +fullscale]; clips.

    bits=None models an ideal converter (identity).  Differentiable via a
    straight-through estimator (see module docstring).
    """
    if bits is None:
        return v
    return _QuantizeSTE.apply(v, bits, fullscale)
