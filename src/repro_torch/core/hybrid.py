"""Compatibility shim, as `repro/core/hybrid.py`: the hybrid subsystem
lives in `repro_torch.hybrid`, and this module re-exports its public
surface so `from repro_torch.core import hybrid` keeps working."""
from repro_torch.hybrid import (  # noqa: F401
    AnalogPreconditioner, KrylovResult, cg_refine, gmres, iterations_to_tol,
    matvec_from_dense, pcg, richardson_refine, solve_refined,
    solve_refined_batched, solve_refined_batched_sharded)
