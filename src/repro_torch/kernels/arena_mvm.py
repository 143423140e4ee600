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

The kernel has two instances, chosen by `plan` from the shapes alone: `smem`
keeps a block's arena slice and the window metadata in shared memory and
streams the operators through a ring (the widest column slice up to 16
whose shared memory fits, and two or three ring slots); `global`, for
an arena too tall for shared memory even one column wide, keeps the arena
in device memory.  A failed build or launch raises; it never picks the
instance.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quantization import quantizer_step
from repro_torch.kernels import _build
from repro_torch.kernels._launch import check as _check
from repro_torch.kernels._launch import (column_slice, launch_on, num_sms,
                                        smem_optin)

_MAX_STAGES = 3         # panels in flight: 3 keep the main path fed
_MAX_KB = 16            # widest column slice of the smem instance


@functools.lru_cache(maxsize=256)
def plan(m: int, s: int, k: int, t: int, c: int, j: int, sms: int,
         optin: int, smem_bytes):
    """(instance, kb, stages) of one launch, from the shapes alone: the
    `smem` instance with the widest column slice, up to 16, that
    `column_slice` allows and whose block fits `optin` bytes of shared
    memory with at least two ring slots (three where they fit), else the
    `global` instance (stages 0) at `column_slice`'s width.
    `smem_bytes(s, t, j, c, kb, stages)` is a block's shared memory, the
    kernel's own `arena_smem_bytes` on the card.  (On an H100 at M=128,
    K=128, 16 columns a block ran faster than 32 or 8.)"""
    def stages(kb):
        for st in range(_MAX_STAGES, 1, -1):
            if smem_bytes(s, t, j, c, kb, st) <= optin:
                return st
        return 0

    if stages(1):
        kb = column_slice(m, k, sms,
                          fits=lambda kb: kb <= _MAX_KB and stages(kb) > 0)
        return "smem", kb, stages(kb)
    return "global", column_slice(m, k, sms), 0


def _kernel_smem_bytes(s: int, t: int, j: int, c: int, kb: int,
                       stages: int) -> int:
    """A block's shared memory by the kernel's own layout
    (`arena_smem_bytes` of the built library)."""
    return _entry()[0].arena_smem_bytes(s, t, j, c, kb, stages)


def device_plan(device: torch.device, m: int, s: int, k: int, t: int,
                c: int, j: int):
    """`plan` of a launch on `device`: its SMs, its shared memory and the
    kernel's layout."""
    return plan(m, s, k, t, c, j, num_sms(device), smem_optin(device),
                _kernel_smem_bytes)


@functools.cache
def _entry():
    """The C entry point with its argument types declared (once)."""
    lib = _build.load("arena_mvm")
    fn = lib.arena_packed_apply_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.arena_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.arena_smem_bytes.restype = ctypes.c_longlong
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
    _, kb, stages = device_plan(dev, m, s, k, t, c, j)
    lib, fn = _entry()
    err = launch_on(dev, lambda stream: fn(
        arena.data_ptr(), ops.data_ptr(), in_offs.data_ptr(),
        in_signs.data_ptr(), out_offs.data_ptr(), out_init.data_ptr(), m, s,
        k, t, r, c, j, kb, stages, dac_bits or 0, dac_step, adc_bits or 0,
        adc_step, fullscale, stream))
    if err != 0:
        raise RuntimeError(f"arena kernel launch failed: "
                           f"{lib.arena_error_string(err).decode()}")
    arena_packed_apply.launches += 1
    return arena


arena_packed_apply.launches = 0
