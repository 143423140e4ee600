"""What the ctypes launchers of `csrc/` share: the card's limits, the
grid's column slice sized to them, and the argument checks."""
from __future__ import annotations

import functools

import torch


@functools.cache
def num_sms(device: torch.device) -> int:
    """Streaming multiprocessors of the card (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def smem_optin(device: torch.device) -> int:
    """Bytes of shared memory one block may opt into (227 KiB on an
    H100)."""
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def column_slice(blocks: int, k: int, sms: int,
                 fits=lambda kb: True) -> int:
    """Rhs columns per CUDA block (a power of two <= 32) for a grid of
    (blocks, ceil(k / kb)): the widest slice that still puts at least one
    block on each of the card's `sms` SMs and whose shared memory `fits`,
    or 1 if none does."""
    kb = 32
    while kb > 1 and (blocks * -(-k // kb) < sms or not fits(kb)):
        kb //= 2
    return kb


def check(name, t, dtype, shape, device):
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device`: what the kernels take."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")
