"""Program keys: the reference's legacy PRNG keys, in numpy.

A key is a `(2,) uint32` numpy array, the layout of the reference's
`jax.random.PRNGKey`.  The serving stack derives one key per programming
event (`fold_in(base, reprograms)`, `fold_in(base, 10_000 + ...)` for a
chaos fault, `fold_in(base, 20_000 + ...)` for a block repair) and the
checkpoint store hashes the key's bytes into its identity check, so
`PRNGKey` and `fold_in` reproduce the reference's threefry2x32 bit for
bit: a store written by either package names its key the same way.

Torch cannot replay the reference's noise draws, so programming does not
use the key's stream: `generator(key)` seeds a fresh CPU
`torch.Generator` with the key's 64 bits, word 0 high, word 1 low.  Each
caller builds its own generator from the key; replicas that program one
matrix under one key then draw the same noise (a generator object shared
between them would hand each replica a different part of one stream).
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def _threefry2x32(k0: int, k1: int, x0: int, x1: int):
    """The 20-round Threefry-2x32 block of one counter pair (x0, x1)
    under key (k0, k1), on Python ints held to 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def as_key(key) -> np.ndarray:
    """`key` (any (2,) array of 32-bit words, a JAX key included) as the
    port's (2,) uint32 numpy key; raises ValueError otherwise."""
    arr = np.asarray(key)
    if arr.shape != (2,) or not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"a key is a (2,) array of 32-bit words, got "
                         f"{arr.dtype}{list(arr.shape)}")
    return arr.astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:                  # noqa: N802
    """`jax.random.PRNGKey(seed)`: [seed >> 32, seed & 0xFFFFFFFF] for a
    seed in [0, 2**32), and a negative int32 seed as its 32-bit pattern."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 64):
        raise ValueError(f"seed {seed} is outside [-2**31, 2**64)")
    hi = 0 if seed < 0 else (seed >> 32) & _MASK
    return np.array([hi, seed & _MASK], dtype=np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)`: threefry2x32 of the counter pair
    (0, data mod 2**32) under `key`."""
    k0, k1 = (int(w) for w in as_key(key))
    return np.array(_threefry2x32(k0, k1, 0, int(data) & _MASK),
                    dtype=np.uint32)


def generator(key) -> torch.Generator:
    """A fresh CPU generator seeded with the key's 64 bits (word 0 high):
    what `ProgrammedSolver.program` draws a key's noise from."""
    k0, k1 = (int(w) for w in as_key(key))
    return torch.Generator().manual_seed((k0 << 32) | k1)
