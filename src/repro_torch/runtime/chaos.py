"""Deterministic fault injection for the serving stack (chaos harness), as
in `repro/runtime/chaos.py`.

Production chaos testing injects failures at random; a *test* harness must
inject them deterministically or the suite flakes.  Everything here is
keyed on the engine's **dispatch counter** - a monotonically increasing
integer the `AsyncSolverEngine` bumps once per dispatch *attempt* - never
on wall-clock time, so a scripted scenario replays identically however
fast or slow the host is.

Three event kinds, mirroring the three production failure surfaces:

* `DispatchException` - the dispatch itself blows up (a device-runtime error, a
  device OOM, a collective timeout surfacing as an exception).  Raised as
  `ScriptedDispatchError`, a `RuntimeError` subclass, so the engine's
  `retry_step` ladder treats it as transient.
* `DispatchLatency` - a straggling dispatch (the `StepWatchdog` failure
  mode): the harness sleeps inside the dispatch attempt.
* `DeviceFault` - the crossbar degrades while it serves: the engine re-programs
  the matrix's arrays under the event's faulty `NonidealConfig` (stuck-at
  rates, drift - the knobs of the physics subsystem), which its
  canary health check then discovers *through the answers*, exactly like a
  real drift/stuck-at failure.  `persistent=True` re-applies the faulty
  config on every recovery re-program too, forcing the engine down the
  quarantine -> re-program -> degrade ladder to the digital fallback.

Events fire once, at the first dispatch whose index reaches `at_dispatch`
(>= semantics: an event scheduled "at 5" still fires if the engine happens
to jump from 4 to 6).  `ChaosInjector.log` records every firing for test
assertions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.nonideal import NonidealConfig


class ScriptedDispatchError(RuntimeError):
    """A chaos-scripted transient dispatch failure (retriable)."""


class ReplicaDeathError(BaseException):
    """A chaos-scripted replica worker-thread death.

    Deliberately *not* a RuntimeError (nor even an Exception): it must
    sail past `retry_step`'s retriable filter and the engine's dispatch
    containment the same way a crashing device runtime or an OOM kill would -
    nothing inside the replica is allowed to catch and survive it.  The
    worker thread dies with queued and in-flight futures unresolved;
    resolving them is the *fleet's* job (replay on survivors), which is
    exactly the contract under test.
    """


@dataclasses.dataclass(frozen=True)
class DispatchException:
    """Raise `ScriptedDispatchError` inside dispatch attempt `at_dispatch`.

    `replica=None` matches any replica; a name scopes the event to one
    engine's dispatch counter in a fleet run.
    """
    at_dispatch: int
    message: str = "chaos: scripted dispatch failure"
    replica: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DispatchLatency:
    """Sleep `seconds` inside dispatch attempt `at_dispatch` (straggler)."""
    at_dispatch: int
    seconds: float
    replica: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ReplicaDeath:
    """Kill `replica`'s worker thread at dispatch attempt `at_dispatch`.

    Raises `ReplicaDeathError` inside the dispatch, which propagates
    through every containment layer and terminates the worker loop with
    its queues intact - the closest software analog of a hard device
    loss.
    """
    at_dispatch: int
    replica: Optional[str] = None
    message: str = "chaos: replica worker death"


@dataclasses.dataclass(frozen=True)
class ReplicaStall:
    """Sustained stall: `replica` sleeps `seconds` on *every* dispatch
    from `at_dispatch` through `until_dispatch` (inclusive) - a replica
    that is alive but useless, the gray-failure case the health score
    (not liveness) must catch.  Unlike one-shot events this stays armed
    across the window.
    """
    at_dispatch: int
    seconds: float
    until_dispatch: int = 1 << 62
    replica: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class CheckpointCorruption:
    """Damage `matrix_id`'s stored programmed state at `at_dispatch`.

    The fleet applies it via `ProgramStore.corrupt(matrix_id, how)`;
    how="values" survives the integrity check and must be caught by the
    physics canary, how="truncate" by the manifest cross-check.
    """
    at_dispatch: int
    matrix_id: str
    how: str = "values"
    replica: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DeviceFault:
    """Degrade `matrix_id`'s programmed arrays before dispatch `at_dispatch`.

    The engine re-programs the matrix under `nonideal` (same dense target,
    deterministic key), simulating a crossbar that developed stuck-at
    faults or drifted - the answers go bad, the canary residual trips.
    `persistent` faults survive recovery: the injector substitutes the
    faulty config for whatever the engine tries to re-program with, so
    health cannot be restored and the engine must degrade to digital.
    """
    at_dispatch: int
    matrix_id: str
    nonideal: NonidealConfig
    persistent: bool = False


@dataclasses.dataclass(frozen=True)
class AcceleratedDrift:
    """Multiply `matrix_id`'s aging rate by `factor` at `at_dispatch`.

    A retention excursion (thermal event, weak conditioning): every
    programmed array of the matrix ages `factor`x faster in device-clock
    time from this dispatch on.  Applied by the engine to the matrix's
    maintenance state, so the background scrubber sees the steepened
    trend and must repair sooner - the forcing function for the
    proactive-repair path.
    """
    at_dispatch: int
    matrix_id: str
    factor: float = 10.0
    replica: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class HotBlock:
    """Age ONE block of `matrix_id` `factor`x faster from `at_dispatch`.

    `block` is a maintenance block ref ("inv"|"mvm", bucket, index) -
    see `core.blockamc.plan_block_map`.  The localized failure mode that
    makes block-granular repair pay: one array degrades while the rest
    of the plan stays healthy, so a whole-matrix re-program would be
    n^2-wasteful.
    """
    at_dispatch: int
    matrix_id: str
    block: Tuple[str, int, int]
    factor: float = 100.0
    replica: Optional[str] = None


ChaosEvent = Union[DispatchException, DispatchLatency, DeviceFault,
                   ReplicaDeath, ReplicaStall, CheckpointCorruption,
                   AcceleratedDrift, HotBlock]


def _matches(e, replica: Optional[str]) -> bool:
    scope = getattr(e, "replica", None)
    return scope is None or scope == replica


class ChaosInjector:
    """Scripted, dispatch-indexed fault schedule for `AsyncSolverEngine`.

    The engine calls exactly three hooks, all from its worker thread (the
    injector needs no locking of its own):

    * `faults_due(idx)` at the start of a dispatch cycle - returns the
      `DeviceFault`s to apply now.
    * `on_dispatch(idx)` inside each dispatch attempt (inside the retry
      ladder, so scripted exceptions exercise it) - sleeps scripted
      latency, raises scripted exceptions.
    * `reprogram_nonideal(matrix_id, cfg)` when recovery re-programs a
      quarantined matrix - persistent faults override the engine's
      recovery config here.
    """

    def __init__(self, events: Sequence[ChaosEvent] = (),
                 sleep: Callable[[float], None] = time.sleep):
        self.events: List[ChaosEvent] = list(events)
        self.sleep = sleep
        self.log: List[Tuple[int, ChaosEvent]] = []   # (dispatch idx, event)
        self._fired: set = set()
        self._persistent: Dict[str, NonidealConfig] = {}

    def _due(self, idx: int, kind,
             replica: Optional[str] = None) -> List[ChaosEvent]:
        due = []
        for i, e in enumerate(self.events):
            if i in self._fired or not isinstance(e, kind):
                continue
            if idx >= e.at_dispatch and _matches(e, replica):
                self._fired.add(i)
                self.log.append((idx, e))
                due.append(e)
        return due

    def faults_due(self, idx: int,
                   replica: Optional[str] = None) -> List[DeviceFault]:
        """Device faults to apply before dispatch cycle `idx` (fire once)."""
        due = self._due(idx, DeviceFault, replica)
        for e in due:
            if e.persistent:
                self._persistent[e.matrix_id] = e.nonideal
        return due

    def aging_due(self, idx: int,
                  replica: Optional[str] = None) -> List[ChaosEvent]:
        """Aging events (AcceleratedDrift / HotBlock) due at dispatch
        cycle `idx` (fire once).  Keyed on the DISPATCH counter like
        every other event - maintenance probes run on a separate counter
        and never consume these indices (the determinism contract)."""
        return (self._due(idx, AcceleratedDrift, replica)
                + self._due(idx, HotBlock, replica))

    def corruptions_due(self, idx: int,
                        replica: Optional[str] = None
                        ) -> List[CheckpointCorruption]:
        """Checkpoint-corruption events due at `idx` (fire once); the
        fleet applies them to its ProgramStore."""
        return self._due(idx, CheckpointCorruption, replica)

    def _stalls_due(self, idx: int,
                    replica: Optional[str]) -> List[ReplicaStall]:
        """Window events: armed on every dispatch inside the window, logged
        only on first firing, retired (fired-once) past the window end."""
        due = []
        for i, e in enumerate(self.events):
            if i in self._fired or not isinstance(e, ReplicaStall):
                continue
            if not _matches(e, replica):
                continue
            if idx > e.until_dispatch:
                self._fired.add(i)
                continue
            if idx >= e.at_dispatch:
                if (i, "logged") not in self._fired:
                    self._fired.add((i, "logged"))
                    self.log.append((idx, e))
                due.append(e)
        return due

    def on_dispatch(self, idx: int, replica: Optional[str] = None) -> None:
        """Latency first (a straggler can also fail), then stalls, then
        deaths, then exceptions.  `replica` scopes the lookup in fleet
        runs; replica-agnostic events (replica=None) always match."""
        for e in self._due(idx, DispatchLatency, replica):
            self.sleep(e.seconds)
        for e in self._stalls_due(idx, replica):
            self.sleep(e.seconds)
        for e in self._due(idx, ReplicaDeath, replica):
            raise ReplicaDeathError(e.message)
        for e in self._due(idx, DispatchException, replica):
            raise ScriptedDispatchError(e.message)

    def reprogram_nonideal(self, matrix_id: str,
                           nonideal: NonidealConfig) -> NonidealConfig:
        """What a recovery re-program of `matrix_id` actually programs
        under: the engine's recovery config, unless a persistent fault
        pins the device in its broken state."""
        return self._persistent.get(matrix_id, nonideal)

    @property
    def fired(self) -> int:
        return len(self.log)
