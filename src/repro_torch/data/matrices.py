"""Benchmark matrix generators from the paper (Section IV.A), as in
`repro/data/matrices.py`:

  * Wishart  A = X^T X / m with X an (m x n) real Gaussian matrix (Eq. 4),
    m = 4n by default (condition number ~9, independent of n)
  * Toeplitz A[i, j] = a_{i-j}, constant along diagonals          (Eq. 5)

Random numbers come from an explicit `torch.Generator` and are drawn on
the generator's device, then moved to `device`; the results run on `cuda`
unless the caller passes `device="cpu"`.  The JAX package draws other
numbers from its keys, so the tests hand both packages numpy arrays.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device


def _randn(generator, shape, dtype, device):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(resolve_device(device))


def wishart(generator: torch.Generator, n: int, *, aspect: float = 4.0,
            dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Wishart matrix A = X^T X / m, X ~ N(0,1)^(m x n), m = aspect*n."""
    m = int(round(aspect * n))
    x = _randn(generator, (m, n), dtype, device)
    return (x.T @ x) / m


def wishart_with_cond(generator: torch.Generator, n: int, cond: float, *,
                      dtype=torch.float32, device="cuda") -> torch.Tensor:
    """SPD matrix with condition number `cond`: a Wishart draw's
    eigenvectors with the spectrum replaced by a log-uniform ramp from 1
    down to 1/cond."""
    _, v = torch.linalg.eigh(wishart(generator, n, dtype=dtype,
                                     device=device))
    eigs = torch.logspace(0.0, -math.log10(cond), n, dtype=dtype,
                          device=v.device)
    return (v * eigs) @ v.T


def toeplitz(generator: torch.Generator, n: int, *, decay: float = 1.0,
             diag_boost: float = 2.0, dtype=torch.float32,
             device="cuda") -> torch.Tensor:
    """Random Toeplitz matrix, invertible w.h.p.: entries a_{-n+1..n-1} ~
    N(0,1) damped by 1/(1+|k|)^decay, main diagonal boosted."""
    coeffs = _randn(generator, (2 * n - 1,), dtype, device)
    k = torch.arange(-(n - 1), n, device=coeffs.device).abs()
    coeffs = coeffs / (1.0 + k.to(dtype)) ** decay
    c0 = coeffs[n - 1]
    coeffs[n - 1] = diag_boost * torch.sign(c0 + 1e-9) * (c0.abs() + 1.0)
    i = torch.arange(n, device=coeffs.device)
    return coeffs[(i[:, None] - i[None, :]) + (n - 1)]


def random_rhs(generator: torch.Generator, n: int, *, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    """Random input vector b, uniform in [-1, 1] (DAC full-scale)."""
    u = torch.rand((n,), generator=generator, dtype=dtype,
                   device=generator.device)
    return (2.0 * u - 1.0).to(resolve_device(device))
