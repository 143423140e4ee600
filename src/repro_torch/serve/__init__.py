"""Solver serving: program once, solve many; drift-aware maintenance."""
from repro_torch.serve.solver_service import (  # noqa: F401
    MatrixStats, SolverService)
from repro_torch.serve.maintenance import (  # noqa: F401
    BlockTrend, DeviceClock, MaintenanceConfig, MatrixMaintenance)
