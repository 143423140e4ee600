"""Serving runtime: fault tolerance, chaos injection, replica placement."""
from repro_torch.runtime.fault_tolerance import StepWatchdog, retry_step  # noqa: F401
from repro_torch.runtime.elastic import ElasticMesh  # noqa: F401
from repro_torch.runtime.chaos import (  # noqa: F401
    AcceleratedDrift, ChaosInjector, CheckpointCorruption, DeviceFault,
    DispatchException, DispatchLatency, HotBlock, ReplicaDeath,
    ReplicaDeathError, ReplicaStall, ScriptedDispatchError)
