"""Launcher of the hand-written block-Thomas sweep kernel
(`csrc/banded_solve.cu`), which replaces the Pallas TPU kernel
`repro/kernels/banded_solve.py::block_tridiag_solve`.

For each batch element b, over a precomputed explicit-inverse factor stack
Minv (nr blocks of s x s), with z_{-1} = 0 and x_{nr} = 0:

    forward:   z_i = Minv_i (rhs_i + gw * z_{i-1})
    backward:  x_i = z_i + gw * Minv_i x_{i+1}

A block owns one batch element and a slice of 8, 16 or 32 rhs columns; a
producer warpgroup streams Minv through a shared-memory ring ahead of the
sweep, and the float32 products run as 3xTF32 `wgmma` (float64 on the
CUDA cores).  The carry (two (s, KB) buffers) lives in shared memory, so
s is bounded by it: s <= 1024 in float32, 992 in float64 (227 KB).

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
from repro_torch.kernels._launch import check, launch_on, num_sms, smem_optin

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
    lib.block_tridiag_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.block_tridiag_smem_bytes.restype = ctypes.c_longlong
    return lib, fn


def column_slice(b: int, k: int, s: int, sms: int, smem: int,
                 smem_bytes) -> int:
    """Rhs columns per block: the narrowest of 8, 16 and 32 whose grid
    (b, ceil(k / kb)) still fits on the card's `sms` SMs in one wave, else
    the widest; only slices whose block fits in `smem` bytes
    (`smem_bytes(s, kb)`), 0 if none does.  The sweeps are a chain of
    dependent steps, and a narrower slice shortens each step's epilogue."""
    fits = [kb for kb in (8, 16, 32) if smem_bytes(s, kb) <= smem]
    for kb in fits:
        if b * -(-k // kb) <= sms:
            return kb
    return fits[-1] if fits else 0


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
    lib, fn = _entry(dtype)
    f64 = int(dtype == torch.float64)
    kb = column_slice(b, k, s, num_sms(dev), smem_optin(dev),
                      lambda s, kb: lib.block_tridiag_smem_bytes(f64, s, kb))
    if kb == 0:
        raise ValueError(f"block size s={s} too large for the carry in "
                         f"shared memory")
    out = torch.empty_like(rhs)
    err = launch_on(dev, lambda stream: fn(
        minv.data_ptr(), rhs.data_ptr(), out.data_ptr(), b, nr, s, k, kb,
        float(gw), stream))
    if err != 0:
        raise RuntimeError(f"block-Thomas kernel launch failed: "
                           f"{lib.block_tridiag_error_string(err).decode()}")
    block_tridiag_solve.launches += 1
    return out


block_tridiag_solve.launches = 0
