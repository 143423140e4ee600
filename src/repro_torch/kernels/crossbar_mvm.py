"""Launcher of the hand-written differential crossbar MVM kernel
(`csrc/crossbar_mvm.cu`), which replaces the Pallas TPU kernels
`repro/kernels/crossbar_mvm.py::crossbar_mvm` and `crossbar_mvm_batched`.

For every array l of a stack, batch row b and output row r:

    out[l, b, r] = ADC((sum_c (gpos - gneg)[l, r, c] * DAC(v[l, b, c]))
                       * (-1/g0))

with 1/g0 rounded once to float32, as the Pallas kernel multiplies by it
(the plain version, like the reference's oracle, divides by g0).  The ADC
sees the complete sum over c.

`crossbar_mvm` (one array: v (B, C), g (R, C)) and `crossbar_mvm_batched`
(a stack: v (L, B, C), g (L, R, C)) take CUDA tensors only and launch on
the current stream, each counting its own launches in `.launches`;
`kernels/ops.py` is the public entry point with the dtype policy and the
CPU dispatch.  A launch is the DAC pass (once per element of v; skipped
for float v with an ideal DAC) and the product on the tensor cores: one
tf32 product where the DAC's output (codes, or widened bf16 v) and G =
gpos - gneg (bf16) are both exact in tf32, two where one of them is
(the other split in two), three (3xTF32) where neither is.
Any L and any B run (one-dimensional grid).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quantization import quantizer_step
from repro_torch.kernels import _build
from repro_torch.kernels._launch import check, launch_on, num_sms

DTYPES = (torch.float32, torch.bfloat16)
CODE_BITS = 12      # DAC codes up to this width are exact in tf32
#                     (|q| <= 2^11; tf32 keeps 11 significant bits)


def exact_codes(dac_bits) -> bool:
    """True where the kernel runs on the DAC's integer codes (exact in
    tf32) and scales by the step after the sum."""
    return bool(dac_bits) and dac_bits <= CODE_BITS


@functools.cache
def _entry():
    """The C entry point with its argument types declared (once)."""
    lib = _build.load("crossbar_mvm")
    fn = lib.crossbar_mvm_apply
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.crossbar_error_string.argtypes = [ctypes.c_int]
    lib.crossbar_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(v, gpos, gneg, g0, dac_bits, adc_bits, fullscale):
    """Check a problem - one array, v (B, C) and g (R, C), or a stack, v
    (L, B, C) and g (L, R, C) - launch, return (B, R) or (L, B, R)."""
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"crossbar kernel needs CUDA tensors, got {dev}")
    if v.dtype not in DTYPES or gpos.dtype not in DTYPES:
        raise ValueError(f"crossbar kernel takes float32 or bfloat16, got "
                         f"v {v.dtype}, g {gpos.dtype}")
    *lead, b, c = v.shape
    r = gpos.shape[-2]
    check("v", v, v.dtype, (*lead, b, c), dev)
    check("gpos", gpos, gpos.dtype, (*lead, r, c), dev)
    check("gneg", gneg, gpos.dtype, (*lead, r, c), dev)
    l = lead[0] if lead else 1
    out = torch.empty((*lead, b, r), dtype=torch.float32, device=dev)
    v_bf16 = v.dtype == torch.bfloat16
    x = (torch.empty(v.shape, dtype=torch.float32, device=dev)
         if dac_bits or v_bf16 else None)     # the DAC pass's output
    dac_step = quantizer_step(dac_bits, fullscale) if dac_bits else 0.0
    adc_step = quantizer_step(adc_bits, fullscale) if adc_bits else 0.0
    lib, fn = _entry()
    err = launch_on(dev, lambda stream: fn(
        v.data_ptr(), gpos.data_ptr(), gneg.data_ptr(), out.data_ptr(),
        None if x is None else x.data_ptr(), int(v_bf16),
        int(gpos.dtype == torch.bfloat16), l, b, r, c, -(1.0 / g0),
        dac_bits or 0, dac_step, int(exact_codes(dac_bits)), adc_bits or 0,
        adc_step, fullscale, num_sms(dev), stream))
    if err != 0:
        raise RuntimeError(f"crossbar kernel launch failed: "
                           f"{lib.crossbar_error_string(err).decode()}")
    return out


def crossbar_mvm(v: torch.Tensor, gpos: torch.Tensor, gneg: torch.Tensor,
                 *, g0: float, dac_bits=None, adc_bits=None,
                 fullscale: float = 1.0) -> torch.Tensor:
    """Launch on one array: v (B, C), gpos/gneg (R, C), contiguous, float32
    or bfloat16 (gpos and gneg alike), on one CUDA device; returns a new
    (B, R) float32 tensor.  bits=None is an ideal converter."""
    if v.ndim != 2:
        raise ValueError(f"v: need (B, C), got {tuple(v.shape)}")
    out = _launch(v, gpos, gneg, g0, dac_bits, adc_bits, fullscale)
    crossbar_mvm.launches += 1
    return out


def crossbar_mvm_batched(v: torch.Tensor, gpos: torch.Tensor,
                         gneg: torch.Tensor, *, g0: float, dac_bits=None,
                         adc_bits=None,
                         fullscale: float = 1.0) -> torch.Tensor:
    """Launch on a stack of L arrays: v (L, B, C), gpos/gneg (L, R, C), as
    `crossbar_mvm`; returns a new (L, B, R) float32 tensor."""
    if v.ndim != 3:
        raise ValueError(f"v: need (L, B, C), got {tuple(v.shape)}")
    out = _launch(v, gpos, gneg, g0, dac_bits, adc_bits, fullscale)
    crossbar_mvm_batched.launches += 1
    return out


crossbar_mvm.launches = 0
crossbar_mvm_batched.launches = 0
