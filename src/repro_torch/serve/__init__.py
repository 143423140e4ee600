"""Solver serving: program once, solve many."""
from repro_torch.serve.solver_service import (  # noqa: F401
    MatrixStats, SolverService)
