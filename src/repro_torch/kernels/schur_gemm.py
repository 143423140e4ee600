"""Launcher of the hand-written fused Schur-complement GEMM
(`csrc/schur_gemm.cu`), which replaces the Pallas TPU kernel
`repro/kernels/schur_gemm.py::schur_update`:

    out = A4 - A3 @ W        (accumulator loaded from A4, products
                              subtracted, one store)

on the tensor cores: float32 as 3xTF32 (wgmma), bfloat16 as one bf16
product (mma.sync), float32 sums either way.

`schur_update` here takes CUDA tensors only and launches the kernel on the
current stream; `kernels/ops.py` is the public entry point with the dtype
policy and the CPU dispatch.  `schur_update.launches` counts the launches
this process made.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check, launch_on, num_sms

DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535
_BLOCK_ROWS = 32            # the kernel's smallest tile: 32 output rows


@functools.cache
def _entry():
    """The C entry point with its argument types declared (once)."""
    lib = _build.load("schur_gemm")
    fn = lib.schur_update_apply
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.schur_error_string.argtypes = [ctypes.c_int]
    lib.schur_error_string.restype = ctypes.c_char_p
    return lib, fn


def schur_update(a4: torch.Tensor, a3: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """Launch A4 - A3 @ W; returns a new (I, J) float32 tensor.

    a4 (I, J), a3 (I, K), w (K, J): contiguous, one dtype (float32 or
    bfloat16), on one CUDA device.
    """
    if a4.device.type != "cuda":
        raise ValueError(f"Schur kernel needs CUDA tensors, got "
                         f"{a4.device}")
    dev, dtype = a4.device, a4.dtype
    if dtype not in DTYPES:
        raise ValueError(f"Schur kernel takes float32 or bfloat16, got "
                         f"{dtype}")
    i, j = a4.shape
    k = a3.shape[1]
    check("a4", a4, dtype, (i, j), dev)
    check("a3", a3, dtype, (i, k), dev)
    check("w", w, dtype, (k, j), dev)
    if -(-i // _BLOCK_ROWS) > _MAX_GRID_Y:
        raise ValueError(f"{i} rows exceed the grid")
    out = a4.new_empty((i, j), dtype=torch.float32)
    lib, fn = _entry()
    err = launch_on(dev, lambda stream: fn(
        a4.data_ptr(), a3.data_ptr(), w.data_ptr(), out.data_ptr(),
        int(dtype == torch.bfloat16), i, j, k, num_sms(dev), stream))
    if err != 0:
        raise RuntimeError(f"Schur kernel launch failed: "
                           f"{lib.schur_error_string(err).decode()}")
    schur_update.launches += 1
    return out


schur_update.launches = 0
