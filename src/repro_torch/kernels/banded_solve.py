"""Launcher of the hand-written block-Thomas sweep kernel
(`csrc/banded_solve.cu`), which replaces the Pallas TPU kernel
`repro/kernels/banded_solve.py::block_tridiag_solve`.

For each batch element b, over a precomputed explicit-inverse factor stack
Minv (nr blocks of s x s), with z_{-1} = 0 and x_{nr} = 0:

    forward:   z_i = Minv_i (rhs_i + gw * z_{i-1})
    backward:  x_i = z_i + gw * Minv_i x_{i+1}

`block_tridiag_solve` here takes CUDA tensors only and launches the kernel
on the current stream; `kernels/ops.py` is the public entry point with the
dtype policy and the CPU dispatch.  `block_tridiag_solve.launches` counts
the launches this process made.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (check, column_slice, num_sms,
                                         smem_optin)

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@functools.cache
def _entry(dtype: torch.dtype):
    """The C entry point for `dtype` with its argument types declared."""
    lib = _build.load("banded_solve")
    fn = getattr(lib, f"block_tridiag_solve_{_SUFFIX[dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.block_tridiag_error_string.argtypes = [ctypes.c_int]
    lib.block_tridiag_error_string.restype = ctypes.c_char_p
    return lib, fn


def smem_bytes(kb: int, s: int, dtype: torch.dtype) -> int:
    """Shared memory of one block: two (KB, s+1) carry buffers."""
    return 2 * kb * (s + 1) * torch.empty((), dtype=dtype).element_size()


def block_tridiag_solve(minv: torch.Tensor, rhs: torch.Tensor, *,
                        gw: float) -> torch.Tensor:
    """Launch the sweeps; returns a new (B, nr, s, k) tensor.

    minv (B, nr, s, s) and rhs (B, nr, s, k): contiguous, one dtype
    (float32 or float64), on one CUDA device.
    """
    if rhs.device.type != "cuda":
        raise ValueError(f"block-Thomas kernel needs CUDA tensors, got "
                         f"{rhs.device}")
    dev, dtype = rhs.device, rhs.dtype
    if dtype not in _SUFFIX:
        raise ValueError(f"block-Thomas kernel takes float32 or float64, "
                         f"got {dtype}")
    b, nr, s, k = rhs.shape
    check("rhs", rhs, dtype, (b, nr, s, k), dev)
    check("minv", minv, dtype, (b, nr, s, s), dev)
    smem_max = smem_optin(dev)
    if smem_bytes(1, s, dtype) > smem_max:
        raise ValueError(f"block size s={s} too large for the carry in "
                         f"shared memory")
    kb = column_slice(b, k, num_sms(dev),
                      fits=lambda kb: smem_bytes(kb, s, dtype) <= smem_max)
    out = torch.empty_like(rhs)
    lib, fn = _entry(dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(minv.data_ptr(), rhs.data_ptr(), out.data_ptr(), b, nr, s,
                 k, kb, float(gw), stream)
    if err != 0:
        raise RuntimeError(f"block-Thomas kernel launch failed: "
                           f"{lib.block_tridiag_error_string(err).decode()}")
    block_tridiag_solve.launches += 1
    return out


block_tridiag_solve.launches = 0
