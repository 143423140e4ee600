"""Hybrid analog-digital solving (paper Section IV), as in `repro/hybrid`.

  * `operators` - `AnalogPreconditioner` (a finalized BlockAMC plan as a
    batched operator M ~ A^-1) and `matvec_from_dense`.
  * `krylov`    - batched `pcg`, `pcg_fixed` and restarted `gmres(m)` with
    per-RHS convergence masks and a true exit residual.
  * `refine`    - the analog-seed -> Krylov-refine path (`solve_refined`,
    with an implicit-function-theorem backward), its Monte-Carlo form
    and that form split over a mesh axis, and
    `solve_fallback`, the digital-only degraded mode.
  * `classic`   - single-rhs Richardson / CG refinement helpers.
"""
from repro_torch.hybrid.classic import (  # noqa: F401
    cg_refine, iterations_to_tol, richardson_refine)
from repro_torch.hybrid.krylov import (  # noqa: F401
    KrylovResult, gmres, pcg, pcg_fixed)
from repro_torch.hybrid.operators import (  # noqa: F401
    AnalogPreconditioner, matvec_from_dense)
from repro_torch.hybrid.refine import (  # noqa: F401
    solve_fallback, solve_refined, solve_refined_batched,
    solve_refined_batched_sharded)
