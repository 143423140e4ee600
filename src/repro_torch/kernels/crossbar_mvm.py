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
(a stack: v (L, B, C), g (L, R, C)) take CUDA tensors only and launch the
one kernel on the current stream, each counting its own launches in
`.launches`; `kernels/ops.py` is the public entry point with the dtype
policy and the CPU dispatch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quantization import quantizer_step
from repro_torch.kernels import _build
from repro_torch.kernels._launch import check, launch_on

DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535
_BLOCK_ROWS = 64            # BB of the kernel: batch rows per block


@functools.cache
def _entry():
    """The C entry point with its argument types declared (once)."""
    lib = _build.load("crossbar_mvm")
    fn = lib.crossbar_mvm_apply
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_float, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.crossbar_error_string.argtypes = [ctypes.c_int]
    lib.crossbar_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(v, gpos, gneg, g0, dac_bits, adc_bits, fullscale):
    """Check a (L, B, C) / (L, R, C) problem, launch, return (L, B, R)."""
    if v.device.type != "cuda":
        raise ValueError(f"crossbar kernel needs CUDA tensors, got "
                         f"{v.device}")
    dev = v.device
    l, b, c = v.shape
    r = gpos.shape[1]
    if v.dtype not in DTYPES or gpos.dtype not in DTYPES:
        raise ValueError(f"crossbar kernel takes float32 or bfloat16, got "
                         f"v {v.dtype}, g {gpos.dtype}")
    check("v", v, v.dtype, (l, b, c), dev)
    check("gpos", gpos, gpos.dtype, (l, r, c), dev)
    check("gneg", gneg, gpos.dtype, (l, r, c), dev)
    if l > _MAX_GRID_YZ or -(-b // _BLOCK_ROWS) > _MAX_GRID_YZ:
        raise ValueError(f"stack of {l} arrays x {b} rows exceeds the grid")
    out = torch.empty((l, b, r), dtype=torch.float32, device=dev)
    dac_step = quantizer_step(dac_bits, fullscale) if dac_bits else 0.0
    adc_step = quantizer_step(adc_bits, fullscale) if adc_bits else 0.0
    lib, fn = _entry()
    err = launch_on(dev, lambda stream: fn(
        v.data_ptr(), gpos.data_ptr(), gneg.data_ptr(), out.data_ptr(),
        int(v.dtype == torch.bfloat16), int(gpos.dtype == torch.bfloat16),
        l, b, r, c, -(1.0 / g0), dac_bits or 0, dac_step, adc_bits or 0,
        adc_step, fullscale, stream))
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
    out = _launch(v[None], gpos[None], gneg[None], g0, dac_bits, adc_bits,
                  fullscale)[0]
    crossbar_mvm.launches += 1
    return out


def crossbar_mvm_batched(v: torch.Tensor, gpos: torch.Tensor,
                         gneg: torch.Tensor, *, g0: float, dac_bits=None,
                         adc_bits=None,
                         fullscale: float = 1.0) -> torch.Tensor:
    """Launch on a stack of L arrays: v (L, B, C), gpos/gneg (L, R, C), as
    `crossbar_mvm`; returns a new (L, B, R) float32 tensor."""
    out = _launch(v, gpos, gneg, g0, dac_bits, adc_bits, fullscale)
    crossbar_mvm_batched.launches += 1
    return out


crossbar_mvm.launches = 0
crossbar_mvm_batched.launches = 0
