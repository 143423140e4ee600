"""Launcher of the hand-written arena tile-program kernel
(`csrc/arena_mvm.cu`), which replaces the Pallas TPU kernel
`repro/kernels/arena_mvm.py::arena_packed_apply`.

For each packed instance i and each tile t in schedule order:

    v   = sum_j in_signs[t, j] * arena[i, in_offs[t, j] : +C]
    out = ADC(ops[i, t] @ DAC(v))
    arena[i, out_offs[t] : +R] {=, +=} out        # per out_init[t]

`arena_packed_apply` here takes CUDA tensors only and launches the kernel
on the current stream; `kernels/ops.py` is the public entry point with the
dtype policy and the CPU dispatch.  `arena_packed_apply.launches` counts
the launches this process made.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quantization import quantizer_step
from repro_torch.kernels import _build
from repro_torch.kernels._launch import check as _check
from repro_torch.kernels._launch import column_slice, num_sms


@functools.cache
def _entry():
    """The C entry point with its argument types declared (once)."""
    lib = _build.load("arena_mvm")
    fn = lib.arena_packed_apply_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.arena_error_string.argtypes = [ctypes.c_int]
    lib.arena_error_string.restype = ctypes.c_char_p
    return lib, fn


def arena_packed_apply(arena: torch.Tensor, ops: torch.Tensor,
                       in_offs: torch.Tensor, in_signs: torch.Tensor,
                       out_offs: torch.Tensor, out_init: torch.Tensor, *,
                       dac_bits=None, adc_bits=None,
                       fullscale: float = 1.0) -> torch.Tensor:
    """Launch the tile program; updates `arena` in place and returns it.

    arena (M, S, K) f32, ops (M, T, R, C) f32, in_offs (T, J) int32,
    in_signs (T, J) f32, out_offs (T,) int32, out_init (T,) int32, all
    contiguous on one CUDA device.  bits=None is an ideal converter.
    """
    if arena.device.type != "cuda":
        raise ValueError(f"arena kernel needs CUDA tensors, got "
                         f"{arena.device}")
    dev = arena.device
    m, s, k = arena.shape
    t, r, c = ops.shape[1:]
    j = in_offs.shape[1] if in_offs.ndim == 2 else -1
    _check("arena", arena, torch.float32, (m, s, k), dev)
    _check("ops", ops, torch.float32, (m, t, r, c), dev)
    _check("in_offs", in_offs, torch.int32, (t, j), dev)
    _check("in_signs", in_signs, torch.float32, (t, j), dev)
    _check("out_offs", out_offs, torch.int32, (t,), dev)
    _check("out_init", out_init, torch.int32, (t,), dev)
    if r > s or c > s:
        raise ValueError(f"tile ({r}, {c}) larger than the arena ({s})")
    dac_step = quantizer_step(dac_bits, fullscale) if dac_bits else 0.0
    adc_step = quantizer_step(adc_bits, fullscale) if adc_bits else 0.0
    lib, fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(arena.data_ptr(), ops.data_ptr(), in_offs.data_ptr(),
                 in_signs.data_ptr(), out_offs.data_ptr(),
                 out_init.data_ptr(), m, s, k, t, r, c, j,
                 column_slice(m, k, num_sms(dev)), dac_bits or 0, dac_step,
                 adc_bits or 0, adc_step, fullscale, stream)
    if err != 0:
        raise RuntimeError(f"arena kernel launch failed: "
                           f"{lib.arena_error_string(err).decode()}")
    arena_packed_apply.launches += 1
    return arena


arena_packed_apply.launches = 0
