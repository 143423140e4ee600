"""Launcher of the hand-written attention kernel (`csrc/flash_attention.cu`),
which replaces the Pallas TPU kernel
`repro/kernels/flash_attention.py::flash_attention`: causal (or full)
online-softmax attention forward over (BH, S, D), scores and
probabilities in float32, `scale = D**-0.5`, the output in the inputs'
type.  Both types run on the tensor cores: bfloat16 as bf16 `wgmma` (TMA;
p enters p.v as the two bf16 parts of its float32 value), float32 as
3xTF32 `wgmma` (every operand, p included, split into two TF32 parts).
Any S and any batch x heads (the grid is one-dimensional); D is 64 or 128
(`HEAD_DIMS`): the model's route takes its chunked path for other head
dims (`models/attention.py`).

`flash_attention` here takes CUDA tensors only and launches the kernel on
the current stream; `kernels/ops.py` is the public entry point with the
dtype policy and the CPU dispatch.  `flash_attention.launches` counts the
launches this process made.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check, launch_on

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 128)


@functools.cache
def _entry():
    """The C entry point with its argument types declared (once)."""
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_apply
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib, fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Launch attention over q, k, v (BH, S, D); returns a new (BH, S, D)
    tensor in their dtype.

    The three are contiguous, of one dtype (float32 or bfloat16), on one
    CUDA device, with D in (64, 128) and 16-byte aligned data.
    Any S: the kernel bounds-checks rows and keys itself.
    """
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    dev, dtype = q.device, q.dtype
    if dtype not in DTYPES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, got "
                         f"{dtype}")
    if q.dim() != 3:
        raise ValueError(f"attention kernel takes (BH, S, D), got "
                         f"{tuple(q.shape)}")
    bh, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dim {HEAD_DIMS}, "
                         f"got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check(name, x, dtype, (bh, s, d), dev)
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    out = torch.empty_like(q)
    lib, fn = _entry()
    err = launch_on(dev, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(dtype == torch.bfloat16), bh, s, d, float(d ** -0.5),
        int(causal), stream))
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: "
                           f"{lib.flash_error_string(err).decode()}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
