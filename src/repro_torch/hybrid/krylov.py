"""Batched Krylov solvers over abstract linear operators, as in
`repro/hybrid/krylov.py`.

Layout contract: right-hand sides ride on *leading* axes - `b` is `(n,)`
for one system or `(batch..., n)` for a multi-RHS batch - and operators
(`matvec`, `precond`) are callables mapping `(..., n) -> (..., n)` over the
trailing axis (see `repro_torch.hybrid.operators`).

Per-RHS convergence masks: each right-hand side carries its own `active`
flag.  A converged column's state is frozen exactly (its step sizes are
masked to zero and its search direction held), so the batched result for a
column matches a solo run of that column up to the order of batched sums.

Convergence is measured as ||b - A x|| <= tol * ||b|| per right-hand side.
`pcg`'s loop exits on the cheap recurrence residual, but the reported
`resnorm`/`converged` recompute the true exit residual with one extra
matvec (`gmres` recomputes it every cycle anyway), so the report never
over-states convergence.  `iters` counts the iterations a column was
active: exact per-column counts for `pcg`, restart-cycle granularity for
`gmres`.  `pcg_fixed` is the fixed-budget variant (no early exit).

Where the reference runs `lax.while_loop` on the device, the port runs a
Python loop whose test - is any column still active? - reads one boolean
back from the card each iteration (`any_active`, which counts those
reads in `any_active.reads`: host reads per Krylov iteration are a layer
metric of the hybrid path).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

Operator = Callable[[torch.Tensor], torch.Tensor]


class KrylovResult(NamedTuple):
    """Per-RHS outcome of a batched Krylov solve (leading-axis layout)."""
    x: torch.Tensor          # (..., n) solutions
    iters: torch.Tensor      # (...,) int32 iterations while active
    resnorm: torch.Tensor    # (...,) final relative residual ||b-Ax||/||b||
    converged: torch.Tensor  # (...,) bool, reached tol within fuel


def any_active(active: torch.Tensor) -> bool:
    """The loop test: whether any column is still active.  One read from
    the device to the host, counted in `any_active.reads`."""
    any_active.reads += 1
    return bool(active.any())


any_active.reads = 0


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(u * v, dim=-1)


def _identity(v: torch.Tensor) -> torch.Tensor:
    return v


def _tiny(dtype: torch.dtype) -> float:
    return torch.finfo(dtype).tiny


def _true_residual(matvec, b, x):
    """(||b - A x||^2, ||b||^2, relative residual) at exit."""
    b2 = _dot(b, b)
    r_true = b - matvec(x)
    rt2 = _dot(r_true, r_true)
    resnorm = torch.sqrt(rt2) / torch.sqrt(
        torch.where(b2 > 0, b2, torch.ones_like(b2)))
    return rt2, b2, resnorm


def pcg(matvec: Operator, b: torch.Tensor, *,
        precond: Optional[Operator] = None,
        x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
        maxiter: int = 1000) -> KrylovResult:
    """Batched preconditioned conjugate gradients (A SPD).

    `matvec`/`precond` map `(..., n) -> (..., n)`; `b` is `(n,)` or
    `(batch..., n)`.  The preconditioner must approximate an SPD inverse.
    Columns whose residual is already below tol (b == 0 included) never
    update.
    """
    mv_m = precond if precond is not None else _identity
    x = torch.zeros_like(b) if x0 is None else x0
    tiny = _tiny(b.dtype)
    stop2 = (tol ** 2) * _dot(b, b)

    r = b - matvec(x)
    z = mv_m(r)
    p = z
    rz = _dot(r, z)
    r2 = _dot(r, r)
    active = r2 > stop2
    iters = torch.zeros(r2.shape, dtype=torch.int32, device=b.device)
    k = 0
    while k < maxiter and any_active(active):
        ap = matvec(p)
        pap = _dot(p, ap)
        alpha = torch.where(active, rz / (pap + tiny),
                            torch.zeros_like(rz))
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * ap
        z = mv_m(r)
        rz_new = _dot(r, z)
        beta = torch.where(active, rz_new / (rz + tiny),
                           torch.zeros_like(rz))
        # frozen columns keep their direction bit-identical
        p = torch.where(active[..., None], z + beta[..., None] * p, p)
        r2 = _dot(r, r)
        rz = torch.where(active, rz_new, rz)
        k += 1
        iters = iters + active.to(torch.int32)
        active = active & (r2 > stop2)
    # truth in reporting: the exit residual recomputed with one matvec
    rt2, _, resnorm = _true_residual(matvec, b, x)
    return KrylovResult(x=x, iters=iters, resnorm=resnorm,
                        converged=rt2 <= stop2)


def pcg_fixed(matvec: Operator, b: torch.Tensor, *,
              precond: Optional[Operator] = None,
              x0: Optional[torch.Tensor] = None, iters: int = 10,
              tol: float = 0.0) -> KrylovResult:
    """Fixed-budget batched PCG: exactly `iters` steps, no early exit and
    no per-column masks (a zero right-hand side is a fixed point of the
    update).  Differentiable by autograd.  Reporting matches `pcg`: one
    true matvec at exit, `converged` against `tol`."""
    mv_m = precond if precond is not None else _identity
    x = torch.zeros_like(b) if x0 is None else x0
    tiny = _tiny(b.dtype)
    r = b - matvec(x)
    z = mv_m(r)
    p, rz = z, _dot(r, z)
    for _ in range(int(iters)):
        ap = matvec(p)
        alpha = rz / (_dot(p, ap) + tiny)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * ap
        z = mv_m(r)
        rz_new = _dot(r, z)
        beta = rz_new / (rz + tiny)
        p = z + beta[..., None] * p
        rz = rz_new
    rt2, b2, resnorm = _true_residual(matvec, b, x)
    return KrylovResult(x=x, iters=torch.full(rt2.shape, int(iters),
                                              dtype=torch.int32,
                                              device=b.device),
                        resnorm=resnorm, converged=rt2 <= (tol ** 2) * b2)


def gmres(matvec: Operator, b: torch.Tensor, *,
          precond: Optional[Operator] = None,
          x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
          restart: int = 32, maxiter: int = 1000) -> KrylovResult:
    """Batched restarted GMRES(m) with right preconditioning (A square).

    Solves `A M u = b, x = M u`, so the monitored residual is the true
    residual.  One cycle is `restart` Arnoldi steps (twice-iterated
    classical Gram-Schmidt, batched over all leading axes) and a batched
    QR least-squares update.  A cycle's update is accepted per column only
    if it does not increase the residual; columns that converge or
    stagnate are masked out of further updates.
    """
    mv_m = precond if precond is not None else _identity
    x = torch.zeros_like(b) if x0 is None else x0
    # a cycle never exceeds maxiter inner steps; whole cycles fit under it
    m = min(int(restart), int(maxiter))
    n = b.shape[-1]
    batch = tuple(b.shape[:-1])
    dtype, dev = b.dtype, b.device
    tiny = _tiny(dtype)
    n_cycles = max(int(maxiter) // m, 1)
    b2 = _dot(b, b)
    stop2 = (tol ** 2) * b2
    eye = torch.eye(m, dtype=dtype, device=dev)
    idx = torch.arange(m + 1, device=dev)

    def op(v):
        return matvec(mv_m(v))

    def cycle(x):
        """One GMRES(m) cycle from x; returns the candidate update."""
        r = b - matvec(x)
        beta = torch.sqrt(_dot(r, r))
        v_basis = torch.zeros(batch + (m + 1, n), dtype=dtype, device=dev)
        v_basis[..., 0, :] = r / (beta + tiny)[..., None]
        h_mat = torch.zeros(batch + (m + 1, m), dtype=dtype, device=dev)
        for j in range(m):
            w = op(v_basis[..., j, :])
            mask = (idx <= j).to(dtype)
            # CGS2: two passes of classical Gram-Schmidt
            h1 = torch.einsum("...in,...n->...i", v_basis, w) * mask
            w = w - torch.einsum("...i,...in->...n", h1, v_basis)
            h2 = torch.einsum("...in,...n->...i", v_basis, w) * mask
            w = w - torch.einsum("...i,...in->...n", h2, v_basis)
            hcol = h1 + h2
            wnorm = torch.sqrt(_dot(w, w))
            hcol[..., j + 1] = wnorm
            v_basis[..., j + 1, :] = w / (wnorm + tiny)[..., None]
            h_mat[..., :, j] = hcol
        # least squares  min_y || beta e1 - H y ||  via batched reduced QR
        e1 = torch.zeros(batch + (m + 1,), dtype=dtype, device=dev)
        e1[..., 0] = beta
        q_f, r_f = torch.linalg.qr(h_mat)
        rhs = torch.einsum("...ij,...i->...j", q_f, e1)
        # guard an exactly singular R (happy breakdown); the acceptance
        # test discards whatever this lets through
        diag = torch.diagonal(r_f, dim1=-2, dim2=-1)
        r_f = r_f + (diag.abs() < tiny).to(dtype)[..., None] * eye
        y = torch.linalg.solve_triangular(r_f, rhs[..., None],
                                          upper=True)[..., 0]
        dx = torch.einsum("...j,...jn->...n", y, v_basis[..., :m, :])
        return x + mv_m(dx)

    r0 = b - matvec(x)
    r2 = _dot(r0, r0)
    iters = torch.zeros(r2.shape, dtype=torch.int32, device=dev)
    active = r2 > stop2
    k = 0
    while k < n_cycles and any_active(active):
        x_new = cycle(x)
        r_new = b - matvec(x_new)
        r2_new = _dot(r_new, r_new)
        take = active & (r2_new <= r2)
        x = torch.where(take[..., None], x_new, x)
        r2_old = r2
        r2 = torch.where(take, r2_new, r2)
        # stagnated columns (no residual decrease) stop burning cycles
        progressed = take & (r2_new < r2_old)
        iters = iters + active.to(torch.int32) * m
        active = progressed & (r2 > stop2)
        k += 1
    # r2 is a true residual: every cycle recomputes b - A x_new and the
    # monotone guard keeps (x, r2) paired
    resnorm = torch.sqrt(r2) / torch.sqrt(
        torch.where(b2 > 0, b2, torch.ones_like(b2)))
    return KrylovResult(x=x, iters=iters, resnorm=resnorm,
                        converged=r2 <= stop2)
