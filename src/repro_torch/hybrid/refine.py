"""The analog-seed -> Krylov-refine path, as in `repro/hybrid/refine.py`.

`solve_refined` is the hybrid solve of the paper's Section IV: one
programmed BlockAMC cascade supplies the seed (`x0 = M b`, one analog
solve) and, optionally, the preconditioner of a digital Krylov iteration
that polishes the seed to digital precision.  Right-hand sides use the
solver-service layout (`(n,)` or `(n, k)` columns); internally they ride
the Krylov solvers' leading axis.

With device noise sigma and condition number kappa, the preconditioned
operator's spectrum is perturbed by O(kappa * sigma * sqrt(n)); when that
is large the noisy inverse can leave the SPD cone and PCG stalls, so
`use_precond=False` refines from the seed alone (plain CG/GMRES), which
always converges on the digital side.

Gradients: at convergence A x = b whatever the iteration's path, so the
implicit function theorem gives the exact adjoint - lambda = A^-T g_x,
b_bar = lambda, A_bar = -sum_cols lambda x^T - and the backward pass is
one more digital, seed-less solve against A^T with the same method and
fuel (`_Refine`, a `torch.autograd.Function`).  Only `x` carries
gradients; the diagnostics and the preconditioner are constants.

`solve_refined_batched` programs one preconditioner per Monte-Carlo
generator (the partitioning hoisted) and refines the same right-hand sides
against each, in turn; `solve_refined_batched_sharded` splits those
generators over a mesh axis (`sharding.partition.mc_refined_specs`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import blockamc
from repro_torch.core.analog import AnalogConfig
from repro_torch.device import resolve_device
from repro_torch.hybrid.krylov import KrylovResult, gmres, pcg
from repro_torch.hybrid.operators import (AnalogPreconditioner,
                                          matvec_from_dense)


def _sanitize_seed(x0: torch.Tensor) -> torch.Tensor:
    """Per-column seed guard: a faulted crossbar can emit non-finite analog
    seeds, and one NaN in `x0` would poison that column's Krylov
    recurrence.  A column with a non-finite entry falls back to the zero
    seed (a cold start) instead."""
    finite = torch.isfinite(x0).all(dim=-1, keepdim=True)
    return torch.where(finite, x0, torch.zeros_like(x0))


def _krylov(a, bt, method, tol, maxiter, restart, precond=None,
            x0=None) -> KrylovResult:
    """CG or GMRES against the dense `a` on leading-axis rhs bt: (..., n)."""
    matvec = matvec_from_dense(a)
    if method == "cg":
        return pcg(matvec, bt, precond=precond, x0=x0, tol=tol,
                   maxiter=maxiter)
    if method == "gmres":
        return gmres(matvec, bt, precond=precond, x0=x0, tol=tol,
                     restart=restart, maxiter=maxiter)
    raise ValueError(f"unknown method {method!r} (want 'cg' or 'gmres')")


def _refine_core(a, bt, precond, method, tol, maxiter, restart,
                 use_precond) -> KrylovResult:
    """The refined solve: the analog seed (one application of `precond`),
    then the Krylov iteration, preconditioned by it if `use_precond`."""
    return _krylov(a, bt, method, tol, maxiter, restart,
                   precond=precond if use_precond else None,
                   x0=_sanitize_seed(precond(bt)))


class _Refine(torch.autograd.Function):
    """The refined solve with its implicit-function-theorem adjoint."""

    @staticmethod
    def forward(ctx, a, bt, precond, method, tol, maxiter, restart,
                use_precond):
        res = _refine_core(a, bt, precond, method, tol, maxiter, restart,
                           use_precond)
        ctx.save_for_backward(a, res.x)
        ctx.opts = (method, tol, maxiter, restart)
        ctx.mark_non_differentiable(res.iters, res.resnorm, res.converged)
        return tuple(res)

    @staticmethod
    def backward(ctx, gx, *_diagnostics):
        a, x = ctx.saved_tensors
        method, tol, maxiter, restart = ctx.opts
        lam = _krylov(a.transpose(-1, -2), gx, method, tol, maxiter,
                      restart).x
        n = a.shape[-1]
        a_bar = -(lam.reshape(-1, n).T @ x.reshape(-1, n)).to(a.dtype)
        return (a_bar, lam.to(gx.dtype)) + (None,) * 6


def _columns(b: torch.Tensor, dtype: torch.dtype):
    """(single?, leading-axis rhs) of an (n,) or (n, k) rhs."""
    single = b.ndim == 1
    return single, (b if single else b.T).to(dtype)


def solve_refined(a, b, precond: AnalogPreconditioner, *,
                  method: str = "cg", tol: float = 1e-10,
                  maxiter: int = 400, restart: int = 32,
                  use_precond: bool = True
                  ) -> Tuple[torch.Tensor, KrylovResult]:
    """Hybrid solve of A x = b: analog seed + digital Krylov refinement,
    on the preconditioner's device.

    Args:
      a:       (n, n) digital system matrix (residuals run in a's dtype -
               float64 for tolerances beyond float32).
      b:       (n,) one rhs or (n, k) columns (solver-service layout).
      precond: programmed analog inverse (seed source; also the Krylov
               preconditioner unless use_precond=False).
      method:  "cg" (A SPD) or "gmres" (general A).
    Returns:
      (x, result): x shaped like b; per-RHS stats in the solvers'
      leading-axis layout.  Differentiable in `a` and `b` (module
      docstring).
    """
    dev = precond.device
    a = torch.as_tensor(a, device=dev)
    single, bt = _columns(torch.as_tensor(b, device=dev), a.dtype)
    res = KrylovResult(*_Refine.apply(a, bt, precond, method, float(tol),
                                      int(maxiter), int(restart),
                                      bool(use_precond)))
    return (res.x if single else res.x.T), res


def solve_fallback(a, b, *, method: str = "cg", tol: float = 1e-8,
                   maxiter: int = 800, restart: int = 32, device="cuda"
                   ) -> Tuple[torch.Tensor, KrylovResult]:
    """Fully digital solve of A x = b on `device`: the degraded serving
    mode.

    No analog seed and no analog preconditioner - a faulted crossbar can
    produce non-finite seeds - so it is correct whatever state the device
    is in, just slower (plain CG/GMRES from zero).  Same layout contract as
    `solve_refined`.
    """
    dev = resolve_device(device)
    a = torch.as_tensor(a, device=dev)
    single, bt = _columns(torch.as_tensor(b, device=dev), a.dtype)
    res = _krylov(a, bt, method, float(tol), int(maxiter), int(restart))
    return (res.x if single else res.x.T), res


def solve_refined_batched(a, b, generators: Sequence[torch.Generator],
                          cfg: AnalogConfig, *,
                          stages: Optional[int] = None, method: str = "cg",
                          tol: float = 1e-10, maxiter: int = 400,
                          restart: int = 32, use_precond: bool = True,
                          mode: str = "fused",
                          device="cuda") -> KrylovResult:
    """Monte-Carlo hybrid solve: one refined solve per generator, on
    `device`.

    Every generator programs its own noisy preconditioner (the digital
    pre-processing hoisted via `partition_system`; each draws in
    `blockamc.program_system`'s order) and refines the same right-hand
    sides.  Returns a KrylovResult with a leading (num_generators, ...)
    axis on every field; `b` may be (n,) or (n, k) (x comes back as
    (S, n) / (S, k, n)).  `mode` picks the preconditioner's executor.
    """
    dev = resolve_device(device)
    a = torch.as_tensor(a, device=dev)
    parts = blockamc.partition_system(a, cfg, stages)
    _, bt = _columns(torch.as_tensor(b, device=dev), a.dtype)
    results = []
    for gen in generators:
        fplan = blockamc.compile_plan(blockamc.program_system(parts, gen,
                                                              cfg))
        precond = AnalogPreconditioner(blockamc.finalize(fplan, cfg),
                                       mode=mode)
        results.append(_Refine.apply(a, bt, precond, method, float(tol),
                                     int(maxiter), int(restart),
                                     bool(use_precond)))
    return KrylovResult(*(torch.stack(field) for field in zip(*results)))


def solve_refined_batched_sharded(a, b,
                                  generators: Sequence[torch.Generator],
                                  cfg: AnalogConfig, *,
                                  stages: Optional[int] = None,
                                  method: str = "cg", tol: float = 1e-10,
                                  maxiter: int = 400, restart: int = 32,
                                  use_precond: bool = True, mesh=None,
                                  axis_name: str = "mc", mode: str = "fused",
                                  device="cuda") -> KrylovResult:
    """`solve_refined_batched` with the generators split over a mesh axis.

    Each rank programs and refines its own share of noisy preconditioners
    (specs `sharding.partition.mc_refined_specs`); the matrix,
    pre-processing and right-hand sides are whole on every rank, and every
    field of the KrylovResult comes back gathered along the key axis in
    rank order.  The number of generators must divide over the axis.
    mesh=None builds `launch.mesh.make_mc_mesh` on `device`.
    """
    from repro_torch.sharding import partition as sp
    dev = resolve_device(device)
    gens = list(generators)
    mesh, rank, count = sp.mc_rank(mesh, axis_name, len(gens), "num_keys",
                                   dev)
    (*_, gspec), out_spec = sp.mc_refined_specs(axis_name)
    res = solve_refined_batched(
        a, b, sp.take_share(gens, gspec, rank, count), cfg, stages=stages,
        method=method, tol=tol, maxiter=maxiter, restart=restart,
        use_precond=use_precond, mode=mode, device=dev)
    return sp.gather_shares(res, mesh, out_spec)
