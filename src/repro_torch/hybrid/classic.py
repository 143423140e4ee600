"""Classic fixed-iteration refinement from an analog seed, as in
`repro/hybrid/classic.py`: Richardson and CG iterations started from the
analog seed, and `iterations_to_tol` - how many digital iterations the
seed saves.  Single right-hand side; the batched solvers are
`repro_torch.hybrid.krylov`.  `iterations_to_tol` reads one residual back
to the host per iteration (the reference's fuel-bounded while loop).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _omega(a: torch.Tensor) -> torch.Tensor:
    """1/||A||_inf, the default Richardson step."""
    return 1.0 / torch.max(torch.sum(torch.abs(a), dim=1))


def richardson_refine(a: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                      iters: int,
                      omega: Optional[float] = None) -> torch.Tensor:
    """x_{k+1} = x_k + omega (b - A x_k); omega defaults to 1/||A||_inf."""
    omega_v = _omega(a) if omega is None else omega
    x = x0
    for _ in range(int(iters)):
        x = x + omega_v * (b - a @ x)
    return x


def cg_refine(a: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
              iters: int) -> torch.Tensor:
    """Conjugate gradients from seed x0 (A SPD; Wishart qualifies)."""
    x = x0
    r = b - a @ x0
    p, rs = r, r @ r
    for _ in range(int(iters)):
        ap = a @ p
        alpha = rs / (p @ ap + 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = r @ r
        beta = rs_new / (rs + 1e-30)
        p = r + beta * p
        rs = rs_new
    return x


def iterations_to_tol(a: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                      tol: float = 1e-6, method: str = "cg",
                      max_iters: int = 2000) -> Tuple[torch.Tensor, int]:
    """Iterate until ||b - Ax||/||b|| < tol; return (x, n_iters).

    n_iters == max_iters means no convergence within fuel.
    """
    b_norm = torch.linalg.norm(b)
    if method == "richardson":
        omega_v = _omega(a)
        x, k = x0, 0
        res = torch.linalg.norm(b - a @ x) / b_norm
        while k < max_iters and bool(res >= tol):
            x = x + omega_v * (b - a @ x)
            res = torch.linalg.norm(b - a @ x) / b_norm
            k += 1
        return x, k
    x = x0
    r = b - a @ x0
    p, rs, k = r, r @ r, 0
    while k < max_iters and bool(torch.linalg.norm(r) / b_norm >= tol):
        ap = a @ p
        alpha = rs / (p @ ap + 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = r @ r
        p = r + (rs_new / (rs + 1e-30)) * p
        rs = rs_new
        k += 1
    return x, k
