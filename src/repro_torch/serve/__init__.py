"""Solver serving: program-once/solve-many, async SLOs, replicated fleet,
drift-aware maintenance."""
from repro_torch.serve.solver_service import (  # noqa: F401
    MatrixStats, SolverService)
from repro_torch.serve.scheduler import PackedSolverScheduler  # noqa: F401
from repro_torch.serve.async_engine import (  # noqa: F401
    AsyncSolverEngine, BackpressureError, DeadlineExceededError,
    EngineError, EngineStats, EngineStoppedError, SolveResult)
from repro_torch.serve.router import (  # noqa: F401
    FleetError, FleetStats, NoReplicaAvailableError, ReplicatedSolverFleet)
from repro_torch.serve.maintenance import (  # noqa: F401
    BlockTrend, DeviceClock, MaintenanceConfig, MatrixMaintenance)
