"""Async solver engine with SLOs: futures, deadlines, backpressure, failover,
as in `repro/serve/async_engine.py`.

`AsyncSolverEngine` turns the synchronous, caller-driven `SolverService`
into a serving engine:

* **Worker-owned device** (a queue hand-off between callers and one
  device thread): ONE background thread owns every device-touching
  operation - programming, packed dispatch, health checks, recovery - with
  the service's card as its current device.  Callers only touch host-side
  admission state under a lock, so no dispatch of this engine ever races
  another.  Every answer of the analog path runs the arena kernel: the
  packed `flush_all` and the per-matrix canary solve.
* **Deadline-aware futures**: `submit` returns a `concurrent.futures
  .Future` resolving to a `SolveResult` (answer + serving metadata) or a
  *typed* error - `DeadlineExceededError`, `EngineStoppedError` - never a
  silent hang.  A request whose deadline expires while still queued is
  shed before compute; one that completes late delivers its answer with
  `deadline_missed=True` (both count as SLO misses).
* **Size OR time flush triggers**: a signature bucket dispatches the
  moment it holds `max_batch` requests, when its oldest request has aged
  `flush_interval`, or when any member's deadline is within
  `deadline_margin` - whichever comes first.
* **Backpressure, never silent drop**: per-signature admission queues are
  bounded at `max_pending`; an overfull bucket rejects with
  `BackpressureError(retry_after_s=...)` at the front door.
* **Fault tolerance on every dispatch**: attempts run under
  `runtime.fault_tolerance.StepWatchdog` (straggler detection + optional
  hard timeout) and `retry_step` (exponential backoff).  A packed
  dispatch that keeps failing falls back to per-matrix isolation so one
  bad tenant cannot take the bucket down.
* **Quarantine -> re-program -> degrade ladder**: after each dispatch the
  engine samples a canary residual ||A x - b|| / ||b|| against the stored
  digital matrix (threshold calibrated at programming time, when the
  device is healthy by construction).  A tripped matrix is quarantined:
  its suspect answers are withheld, the arrays are re-programmed with a
  fresh key under the recovery config (write-verify + fault remapping
  on - the standard mitigations for the drift/stuck-at failure modes in
  `physics/dynamics.py` / `physics/faults.py`), and the in-flight
  requests replay against the fresh arrays.  If `max_reprograms`
  re-programs cannot restore health the matrix degrades to the digital
  `hybrid.refine.solve_fallback` path - every answer still arrives, with
  `mode="digital"` in its metadata.  Recovery health is always judged
  against the *original* calibration threshold, so a broken device can
  never grade its own homework.

Determinism: `runtime.chaos.ChaosInjector` hooks all three fault surfaces
(scripted dispatch exceptions, scripted latency, device faults via the
`NonidealConfig` physics knobs) keyed on the engine's dispatch counter,
so the whole failover ladder is exercised deterministically in the tests.

Keys are the reference's (`repro_torch.keys`): the engine derives each
re-program's key with `fold_in` at the reference's offsets (`reprograms`,
`10_000 +` for a chaos fault, `20_000 +` for a block repair), and draws
the noise from `keys.generator(key)`, a fresh generator per programming.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import keys
from repro_torch.checkpoint.program_store import CheckpointRejectedError
from repro_torch.device import device_scope
from repro_torch.runtime.chaos import HotBlock, ReplicaDeathError
from repro_torch.runtime.fault_tolerance import StepWatchdog, retry_step
from repro_torch.serve.maintenance import MaintenanceConfig, MatrixMaintenance
from repro_torch.serve.solver_service import _host

log = logging.getLogger("repro_torch.serve.async_engine")


# ---------------------------------------------------------------------------
# Typed errors: a future resolves to an answer or one of these - never hangs
# ---------------------------------------------------------------------------

class EngineError(RuntimeError):
    """Base class for every engine-surfaced request failure."""


class BackpressureError(EngineError):
    """Admission rejected: the bucket is full.  `retry_after_s` estimates
    when the next flush will have drained it - retry then, don't spin."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DeadlineExceededError(EngineError):
    """The request's deadline passed before an answer could be computed."""


class EngineStoppedError(EngineError):
    """The engine stopped (without drain) before answering this request."""


# ---------------------------------------------------------------------------
# Result / bookkeeping records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SolveResult:
    """One answered request plus its serving metadata."""
    x: np.ndarray             # (n,) host-resident solution
    matrix_id: str
    mode: str                 # "analog" | "digital" (degraded fallback)
    health: str               # matrix status at answer time
    reprograms: int           # recovery re-programs this matrix has had
    latency_s: float          # submit -> answer wall time
    deadline_missed: bool     # answered, but after the deadline
    dispatch_index: int       # engine dispatch attempt that answered it
    attempts: int             # dispatch attempts the flush needed (>=1)


@dataclasses.dataclass
class EngineStats:
    """Engine-lifetime counters (worker-written; read after quiescence)."""
    submitted: int = 0
    answered: int = 0
    rejected: int = 0          # BackpressureError at admission
    expired: int = 0           # shed before compute (deadline passed)
    deadline_misses: int = 0   # expired + answered-late
    dispatches: int = 0        # dispatch attempts (retries included)
    retries: int = 0
    straggles: int = 0         # watchdog-flagged slow dispatches
    isolations: int = 0        # packed dispatch fell back to per-matrix
    quarantines: int = 0
    reprograms: int = 0
    degraded: int = 0          # matrices that ended up on the digital path
    replays: int = 0           # requests replayed after a quarantine
    fallback_rhs: int = 0      # rhs answered by the digital fallback
    cancelled: int = 0         # requests cancelled while still queued
    scrub_probes: int = 0      # per-block maintenance canary MVMs
    age_refreshes: int = 0     # plan re-finalizations at new device ages
    repairs: int = 0           # block-repair rounds
    blocks_repaired: int = 0   # physical arrays re-programmed in place
    recovery_s: List[float] = dataclasses.field(default_factory=list)


class _Request:
    __slots__ = ("matrix_id", "b", "deadline", "future", "t_submit")

    def __init__(self, matrix_id: str, b: np.ndarray,
                 deadline: Optional[float], future: Future,
                 t_submit: float):
        self.matrix_id = matrix_id
        self.b = b
        self.deadline = deadline      # absolute time.monotonic(), or None
        self.future = future
        self.t_submit = t_submit


class _MatrixState:
    __slots__ = ("a", "n", "base_key", "base_cfg", "sig", "status",
                 "reprograms", "canary", "canary_norm", "trip",
                 "last_canary", "maint")

    def __init__(self, a: np.ndarray, base_key, base_cfg, sig):
        self.a = a                    # host numpy dense copy (residuals)
        self.n = a.shape[0]
        self.base_key = base_key
        self.base_cfg = base_cfg
        self.sig = sig
        self.status = "healthy"       # "healthy" | "degraded"
        self.reprograms = 0
        # deterministic canary rhs: fixed ramp, unit norm - no RNG, so the
        # health tripwire is identical run to run
        c = np.linspace(1.0, 2.0, self.n).astype(a.dtype)
        self.canary = c / np.linalg.norm(c)
        self.canary_norm = float(np.linalg.norm(self.canary))
        self.trip = np.inf            # calibrated right after programming
        self.last_canary = 0.0        # latest measured canary residual
        self.maint = None             # MatrixMaintenance when clock-driven


class AsyncSolverEngine:
    """Background-worker serving engine over a `SolverService`.

    The engine must be the service's only user once started: programming,
    submission and flushing all route through it (the service's own queues
    are used only transiently inside a dispatch attempt, so the service is
    always re-programmable between cycles - the failover precondition).
    The engine runs on its service's device; `device`, when given, must be
    that device.
    """

    def __init__(self, service, *, max_batch: int = 8,
                 flush_interval: float = 0.05,
                 max_pending: int = 64,
                 deadline_margin: float = 0.02,
                 retries: int = 2, backoff: float = 0.01,
                 watchdog_factor: float = 3.0,
                 watchdog_timeout: Optional[float] = None,
                 health_factor: float = 10.0,
                 health_floor: float = 1e-3,
                 health_check_every: int = 1,
                 max_reprograms: int = 2,
                 recovery_nonideal=None,
                 fallback_method: str = "cg",
                 fallback_tol: float = 1e-6,
                 fallback_maxiter: int = 800,
                 chaos=None,
                 clock=None,
                 maintenance: Optional[MaintenanceConfig] = None,
                 scrub: bool = True,
                 repair_gate=None,
                 on_repair=None,
                 name: str = "engine",
                 device=None):
        if device is not None and torch.device(device) != service.device:
            raise ValueError(f"engine device {device} differs from its "
                             f"service's {service.device}")
        self.service = service
        self.name = name              # chaos scope + fleet identity
        self.device = service.device  # the worker's current device
        self.max_batch = int(max_batch)
        self.flush_interval = float(flush_interval)
        self.max_pending = int(max_pending)
        self.deadline_margin = float(deadline_margin)
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.health_factor = float(health_factor)
        self.health_floor = float(health_floor)
        self.health_check_every = int(health_check_every)
        self.max_reprograms = int(max_reprograms)
        self.recovery_nonideal = recovery_nonideal
        self.fallback_kw = dict(method=fallback_method, tol=fallback_tol,
                                maxiter=fallback_maxiter)
        self.chaos = chaos
        # drift-aware self-healing (see serve/maintenance.py DESIGN note):
        # `clock` turns on simulated device aging; `scrub=False` keeps the
        # aging but disables the proactive scrub/repair loop (the reactive
        # baseline the maintenance tests compare against).
        # `repair_gate` is a lock-free callable the fleet uses to stagger
        # repair windows (it is read inside the worker's wait predicate
        # with the engine lock held, so it MUST NOT take other locks);
        # `on_repair(matrix_id, solver, key)` lets the fleet re-checkpoint
        # repaired plans.
        self.clock = clock
        self.maintenance = (maintenance if maintenance is not None
                            else MaintenanceConfig())
        self.scrub_on = bool(scrub)
        self.repair_gate = repair_gate
        self.on_repair = on_repair
        self._maint_count = 0         # probe/repair counter - NEVER the
        #                               dispatch counter (chaos determinism)
        self.stats = EngineStats()
        self._watchdog = StepWatchdog(
            factor=watchdog_factor, warmup_steps=5,
            hard_timeout=watchdog_timeout,
            on_straggle=self._on_straggle)

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues: Dict[tuple, List[_Request]] = {}
        self._matrix: Dict[str, _MatrixState] = {}
        self._control: List[Tuple[str, tuple, Future]] = []
        self._force_flush = False
        self._running = False
        self._drain_on_stop = True
        self._crashed = False
        self._dispatch_count = 0
        self._cycles = 0
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "AsyncSolverEngine":
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("engine already running")
        self._running = True
        self._crashed = False
        self._thread = threading.Thread(
            target=self._worker_entry,
            name=f"amc-engine-worker-{self.name}", daemon=True)
        self._thread.start()
        if self.clock is not None:
            self.clock.subscribe(self._wake)
        return self

    @property
    def alive(self) -> bool:
        """Worker thread running and not crashed."""
        return (self._thread is not None and self._thread.is_alive()
                and not self._crashed)

    @property
    def crashed(self) -> bool:
        return self._crashed

    def _on_device(self):
        return device_scope(self.device)

    def _worker_entry(self) -> None:
        """Worker thread entry: pins the device and models hard death.

        A `ReplicaDeathError` (chaos-scripted or real) terminates the
        loop *without* draining: queued and in-flight futures stay
        unresolved, exactly like a process kill.  Resolving them is the
        fleet's replay contract, not the dying replica's."""
        try:
            with self._on_device():
                self._worker_loop()
        except ReplicaDeathError as e:
            with self._lock:
                self._crashed = True
                self._running = False
            log.error("replica %r worker died: %s", self.name, e)
        except BaseException as e:                     # noqa: BLE001
            # any OTHER escape is a worker crash too: mark the engine
            # dead so `submit` raises EngineStoppedError immediately
            # instead of enqueueing into a thread that no longer exists
            # (futures would hang forever)
            with self._lock:
                self._crashed = True
                self._running = False
            log.exception("engine %r worker crashed: %s", self.name, e)

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the worker.  drain=True answers everything still queued
        first; drain=False resolves leftovers with `EngineStoppedError`.
        Raises if the worker fails to exit within `timeout` (a deadlock
        must fail loudly, not hang the caller)."""
        if self.clock is not None:
            self.clock.unsubscribe(self._wake)
        with self._work:
            self._running = False
            self._drain_on_stop = drain
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    "engine worker did not exit within "
                    f"{timeout}s - possible deadlock")

    def __enter__(self) -> "AsyncSolverEngine":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop(drain=exc_type is None)
        return False

    # ------------------------------------------------------------------
    # programming (device-touching: runs on the worker once started)
    # ------------------------------------------------------------------

    def program(self, matrix_id: str, a, key=None, cfg=None) -> None:
        """Program a matrix for serving (blocks until hot + calibrated).

        Before `start()` this runs inline; after, it hands off to the
        worker thread (which owns the device) and blocks on the result,
        so callers never race a dispatch.  `cfg` optionally overrides
        the service default per matrix (composes with plan_signature)."""
        self._run_on_worker("program", (matrix_id, a, key, cfg))

    def install(self, matrix_id: str, solver, a, key, trip: float,
                cfg=None) -> None:
        """Install an already-programmed solver (checkpoint restore path).

        Skips the whole programming pipeline - the solver's conductance
        stacks were paid for earlier and persisted.  The canary still
        runs against `trip`, the threshold calibrated at ORIGINAL program
        time: a restored plan that cannot beat the health bar it was
        saved under is rejected with `CheckpointRejectedError` (the
        caller then falls back to full re-programming).  Same worker
        handoff as `program`."""
        self._run_on_worker("install", (matrix_id, solver, a, key, trip,
                                        cfg))

    def _run_on_worker(self, op: str, args: tuple) -> None:
        if self._thread is None or not self._thread.is_alive():
            with self._on_device():
                self._do_control(op, args)
            return
        fut: Future = Future()
        with self._work:
            if not self._running:
                raise EngineStoppedError("engine is stopping")
            self._control.append((op, args, fut))
            self._work.notify_all()
        fut.result()

    def _do_control(self, op: str, args: tuple) -> None:
        if op == "program":
            self._do_program(*args)
        elif op == "install":
            self._do_install(*args)
        else:                                          # pragma: no cover
            raise ValueError(f"unknown control op {op!r}")

    def _do_program(self, matrix_id: str, a, key, cfg=None) -> None:
        key = keys.as_key(key) if key is not None else keys.PRNGKey(0)
        self.service.program(matrix_id, a, keys.generator(key), cfg=cfg)
        st = _MatrixState(_host(a), key,
                          self.service.matrix_cfg(matrix_id),
                          self.service.signature(matrix_id))
        # calibrate the health tripwire while the device is healthy by
        # construction: trip = max(floor, factor x fresh canary residual).
        # Stored once - recovery must beat THIS threshold, so a faulted
        # re-program can never recalibrate itself into "healthy".
        baseline = self._canary_residual(matrix_id, st)
        st.trip = max(self.health_floor, self.health_factor * baseline)
        self._init_maint(matrix_id, st)
        with self._lock:
            self._matrix[matrix_id] = st

    def _do_install(self, matrix_id: str, solver, a, key, trip: float,
                    cfg=None) -> None:
        self.service.install(matrix_id, solver, a, cfg=cfg)
        st = _MatrixState(_host(a), keys.as_key(key),
                          self.service.matrix_cfg(matrix_id),
                          self.service.signature(matrix_id))
        st.trip = float(trip)
        resid = self._canary_residual(matrix_id, st)
        if not (resid <= st.trip):
            raise CheckpointRejectedError(
                f"restored plan for {matrix_id!r} fails its original "
                f"calibration: canary residual {resid:.3e} > trip "
                f"{st.trip:.3e}")
        self._init_maint(matrix_id, st)
        with self._lock:
            self._matrix[matrix_id] = st

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, matrix_id: str, b, *,
               deadline_s: Optional[float] = None) -> Future:
        """Queue one (n,) rhs; returns a Future[SolveResult].

        `deadline_s` is relative (seconds from now).  Raises
        `BackpressureError` when the bucket is full, `ValueError` on
        malformed input, `KeyError` on an unknown matrix - all before any
        state changes, on the caller's thread."""
        with self._lock:
            if not self._running:
                raise EngineStoppedError("engine is not running")
            st = self._matrix[matrix_id]
        b_host = _host(b)             # snapshot, like SolverService.submit
        if b_host.shape != (st.n,):
            raise ValueError(
                f"submit takes one ({st.n},) rhs, got {b_host.shape}")
        if not np.issubdtype(b_host.dtype, np.floating):
            raise ValueError(f"rhs must be float, got {b_host.dtype}")
        if not np.all(np.isfinite(b_host)):
            raise ValueError(f"rhs for {matrix_id!r} contains non-finite "
                             f"entries; rejected at admission")
        now = time.monotonic()
        deadline = None if deadline_s is None else now + float(deadline_s)
        fut: Future = Future()
        req = _Request(matrix_id, b_host, deadline, fut, now)
        with self._work:
            # a stopped engine AND a dead worker both refuse immediately:
            # enqueueing behind a thread that will never drain the queue
            # turns "typed error now" into "future hangs forever"
            if not self._running or self._crashed or (
                    self._thread is not None
                    and not self._thread.is_alive()):
                raise EngineStoppedError("engine is not running")
            q = self._queues.setdefault(st.sig, [])
            if len(q) >= self.max_pending:
                self.stats.rejected += 1
                oldest = q[0].t_submit
                retry_after = max(
                    0.0, oldest + self.flush_interval - now) or \
                    self.flush_interval
                raise BackpressureError(
                    f"bucket for {matrix_id!r} holds {len(q)} pending rhs "
                    f"(max_pending={self.max_pending}); retry after "
                    f"~{retry_after:.3f}s", retry_after)
            q.append(req)
            self.stats.submitted += 1
            self._work.notify_all()
        return fut

    def flush_now(self) -> None:
        """Force every non-empty bucket due on the next worker wakeup."""
        with self._work:
            self._force_flush = True
            self._work.notify_all()

    def cancel(self, fut: Future) -> bool:
        """Cancel a still-queued request (the hedge-loser path).

        Returns True if the request was removed before dispatch; False
        once it left the queue (the answer will arrive anyway - the
        caller just ignores it).  Never interrupts a running dispatch."""
        with self._work:
            for sig, q in self._queues.items():
                for i, r in enumerate(q):
                    if r.future is fut:
                        del q[i]
                        self.stats.cancelled += 1
                        fut.cancel()
                        return True
        return False

    def outstanding(self) -> List[Tuple[str, np.ndarray, Optional[float],
                                        Future]]:
        """Snapshot of still-queued requests as (matrix_id, b, deadline,
        future) - the fleet's replay source when this replica dies."""
        with self._lock:
            return [(r.matrix_id, r.b, r.deadline, r.future)
                    for q in self._queues.values() for r in q]

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def matrix_status(self, matrix_id: str) -> str:
        with self._lock:
            return self._matrix[matrix_id].status

    def matrix_trip(self, matrix_id: str) -> float:
        """The health-trip threshold calibrated at program time."""
        with self._lock:
            return float(self._matrix[matrix_id].trip)

    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def health_snapshot(self) -> Dict[str, object]:
        """Cheap, lock-scoped health export for a router's scorer.

        "maintenance" carries the per-matrix drift gauges (trend slope,
        predicted time-to-trip, scrub backlog, blocks repaired, ...) -
        report-only observability, surfaced through the fleet's
        `maintenance_gauges`."""
        t_now = self.clock.now() if self.clock is not None else 0.0
        with self._lock:
            canaries = {mid: st.last_canary
                        for mid, st in self._matrix.items()}
            trips = {mid: st.trip for mid, st in self._matrix.items()}
            statuses = {mid: st.status for mid, st in self._matrix.items()}
            maint = {mid: st.maint.gauges(t_now)
                     for mid, st in self._matrix.items()
                     if st.maint is not None}
            return {
                "name": self.name,
                "alive": (self._thread is not None
                          and self._thread.is_alive()
                          and not self._crashed),
                "queue_depth": sum(len(q) for q in self._queues.values()),
                "answered": self.stats.answered,
                "deadline_misses": self.stats.deadline_misses,
                "quarantines": self.stats.quarantines,
                "canary": canaries,
                "trip": trips,
                "status": statuses,
                "scrub_probes": self.stats.scrub_probes,
                "repairs": self.stats.repairs,
                "blocks_repaired": self.stats.blocks_repaired,
                "maintenance": maint,
            }

    def health(self) -> Dict[str, object]:
        """Alias of `health_snapshot` (the observability entry point)."""
        return self.health_snapshot()

    @property
    def maintenance_pending(self) -> int:
        """Blocks currently scheduled for repair (the fleet's staggering
        signal: a replica with pending repairs wants the repair token)."""
        with self._lock:
            return sum(len(st.maint.pending)
                       for st in self._matrix.values()
                       if st.maint is not None)

    def maintenance_quiesce(self, timeout: float = 30.0) -> bool:
        """Block until the scrubber has nothing left to do at the current
        device time (ages synced, backlog probed, allowed repairs done).
        Returns False on timeout.  Deterministic-scenario helper: advance
        the clock, quiesce, then drive traffic."""
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._lock:
                due = self._maint_due() and not self._crashed
            if not due:
                return True
            time.sleep(0.002)
        return False

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------

    def _on_straggle(self, dt: float, median: float) -> None:
        self.stats.straggles += 1
        log.warning("straggling dispatch: %.3fs (median %.3fs)", dt, median)

    def _bucket_due(self, q: List[_Request], now: float) -> bool:
        if not q:
            return False
        if self._force_flush or len(q) >= self.max_batch:
            return True
        if now - q[0].t_submit >= self.flush_interval:
            return True
        return any(r.deadline is not None
                   and r.deadline - now <= self.deadline_margin for r in q)

    def _next_wakeup(self, now: float) -> Optional[float]:
        """Seconds until the earliest time/deadline trigger, None = idle."""
        t_due = None
        for q in self._queues.values():
            if not q:
                continue
            t = q[0].t_submit + self.flush_interval
            for r in q:
                if r.deadline is not None:
                    t = min(t, r.deadline - self.deadline_margin)
            t_due = t if t_due is None else min(t_due, t)
        if t_due is None:
            return None
        return max(0.0, t_due - now)

    def _worker_loop(self) -> None:
        while True:
            with self._work:
                now = time.monotonic()
                while (self._running and not self._control
                       and not any(self._bucket_due(q, now)
                                   for q in self._queues.values())
                       and not self._maint_due()):
                    self._work.wait(self._next_wakeup(now))
                    now = time.monotonic()
                if not self._running:
                    break
                control = self._control
                self._control = []
                due: List[Tuple[tuple, List[_Request]]] = []
                for sig, q in self._queues.items():
                    if self._bucket_due(q, now):
                        due.append((sig, q))
                        self._queues[sig] = []
                self._force_flush = False
            for op, args, fut in control:
                self._run_control(op, args, fut)
            for _, reqs in due:
                self._dispatch_cycle(reqs)
            if not control and not due:
                # pure maintenance wakeup: the engine scrubs/repairs only
                # on otherwise-idle cycles, so foreground traffic always
                # wins the worker
                self._maintenance_cycle()
        # stopped: drain or void what's left
        with self._lock:
            leftovers = [r for q in self._queues.values() for r in q]
            for sig in self._queues:
                self._queues[sig] = []
            control = self._control
            self._control = []
        for op, args, fut in control:
            fut.set_exception(EngineStoppedError("engine stopped"))
        if self._drain_on_stop and leftovers:
            by_sig: Dict[tuple, List[_Request]] = {}
            for r in leftovers:
                by_sig.setdefault(self._matrix[r.matrix_id].sig,
                                  []).append(r)
            for reqs in by_sig.values():
                self._dispatch_cycle(reqs)
        else:
            for r in leftovers:
                r.future.set_exception(
                    EngineStoppedError("engine stopped before dispatch"))

    def _run_control(self, op: str, args: tuple, fut: Future) -> None:
        try:
            self._do_control(op, args)
            fut.set_result(None)
        except ReplicaDeathError:
            fut.set_exception(EngineStoppedError(
                f"replica {self.name!r} died during {op}"))
            raise
        except BaseException as e:                     # noqa: BLE001
            fut.set_exception(e)

    # ------------------------------------------------------------------
    # dispatch cycle (worker thread only)
    # ------------------------------------------------------------------

    def _dispatch_cycle(self, reqs: List[_Request]) -> None:
        try:
            self._dispatch_cycle_inner(reqs)
        except ReplicaDeathError:
            # hard replica death is NOT contained: the worker dies with
            # these futures unresolved (the fleet replays them), exactly
            # like a process kill mid-dispatch
            raise
        except BaseException as e:                     # noqa: BLE001
            # last-resort containment: no future may ever hang
            log.exception("dispatch cycle failed: %s", e)
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)

    def _dispatch_cycle_inner(self, reqs: List[_Request]) -> None:
        self._cycles += 1
        now = time.monotonic()
        # 1. shed requests whose deadline already passed - no compute
        live: List[_Request] = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self.stats.expired += 1
                self.stats.deadline_misses += 1
                r.future.set_exception(DeadlineExceededError(
                    f"deadline passed {now - r.deadline:.3f}s before "
                    f"dispatch of {r.matrix_id!r}"))
            else:
                live.append(r)
        if not live:
            return
        # 2. scripted device faults land before the dispatch (chaos);
        #    aging events (accelerated drift / hot blocks) are keyed on
        #    the same dispatch counter - only maintenance PROBES live on
        #    a separate counter
        if self.chaos is not None:
            for ev in self.chaos.faults_due(self._dispatch_count, replica=self.name):
                self._apply_device_fault(ev)
            for ev in self.chaos.aging_due(self._dispatch_count,
                                           replica=self.name):
                self._apply_aging_event(ev)
        # 2b. bake current device ages into the serving plans, so this
        #     dispatch (and its canary) sees the drift accumulated since
        #     the last sync - with or without scrubbing enabled
        self._sync_clock()
        # 3. split per matrix, healthy vs degraded
        groups: Dict[str, List[_Request]] = {}
        for r in live:
            groups.setdefault(r.matrix_id, []).append(r)
        healthy = {mid: rs for mid, rs in groups.items()
                   if self._matrix[mid].status == "healthy"}
        degraded = {mid: rs for mid, rs in groups.items()
                    if self._matrix[mid].status != "healthy"}
        # 4. packed dispatch of the healthy fleet, with per-matrix
        #    isolation as the fallback when the pack itself keeps failing
        if healthy:
            try:
                answers, attempts = self._dispatch_packed(healthy)
                self._settle_healthy(healthy, answers, attempts)
            except Exception as e:                     # noqa: BLE001
                log.warning("packed dispatch failed after retries (%s); "
                            "isolating per matrix", e)
                self.stats.isolations += 1
                self._dispatch_isolated(healthy)
        # 5. degraded tenants always answer via the digital fallback
        for mid, rs in degraded.items():
            self._serve_fallback(mid, rs)

    # -- packed path ----------------------------------------------------

    def _dispatch_packed(self, groups: Dict[str, List[_Request]]):
        ids = list(groups)
        for mid, rs in groups.items():
            for r in rs:
                self.service.submit(mid, r.b)
        attempts = [0]

        def attempt():
            attempts[0] += 1
            idx = self._next_dispatch_index()
            if self.chaos is not None:
                self.chaos.on_dispatch(idx, replica=self.name)
            with self._watchdog:
                return self.service.flush_all(ids)

        try:
            # flush_all is all-or-nothing: a failed attempt leaves the
            # service queues intact, so retries re-flush the same batch
            answers = retry_step(
                attempt, retries=self.retries, backoff=self.backoff,
                on_retry=lambda i, e: self._count_retry(e))
        except BaseException:
            for mid in ids:
                self.service.discard_pending(mid)
            raise
        return answers, attempts[0]

    def _settle_healthy(self, groups: Dict[str, List[_Request]],
                        answers: Dict[str, np.ndarray],
                        attempts: int) -> None:
        """Health-gate each matrix's answers; resolve or quarantine.

        Two passes so a slow recovery never delays its co-batched
        neighbours: every matrix that passes its canary resolves first,
        then the tripped ones (answers withheld - they were computed on a
        faulted device) go down the recovery ladder."""
        check = (self._cycles % self.health_check_every) == 0
        tripped: List[Tuple[str, List[_Request]]] = []
        for mid, rs in groups.items():
            st = self._matrix[mid]
            if check and not self._matrix_healthy(mid, st):
                tripped.append((mid, rs))
                continue
            xs = answers[mid]
            for j, r in enumerate(rs):
                self._resolve(r, xs[:, j], "analog", attempts)
        for mid, rs in tripped:
            self._quarantine_and_recover(mid, rs)

    # -- isolation path -------------------------------------------------

    def _dispatch_isolated(self, groups: Dict[str, List[_Request]]) -> None:
        """Per-matrix dispatch after a packed failure: survivors answer,
        repeat offenders go down the quarantine ladder."""
        for mid, rs in groups.items():
            for r in rs:
                self.service.submit(mid, r.b)
            attempts = [0]

            def attempt(mid=mid):
                attempts[0] += 1
                idx = self._next_dispatch_index()
                if self.chaos is not None:
                    self.chaos.on_dispatch(idx, replica=self.name)
                with self._watchdog:
                    return self.service.flush(mid).cpu().numpy()

            try:
                xs = retry_step(
                    attempt, retries=self.retries, backoff=self.backoff,
                    on_retry=lambda i, e: self._count_retry(e))
            except Exception:                          # noqa: BLE001
                self.service.discard_pending(mid)
                self._quarantine_and_recover(mid, rs)
                continue
            st = self._matrix[mid]
            if not self._matrix_healthy(mid, st):
                self._quarantine_and_recover(mid, rs)
                continue
            for j, r in enumerate(rs):
                self._resolve(r, xs[:, j], "analog", attempts[0])

    # -- health / recovery ladder ---------------------------------------

    def _canary_residual(self, mid: str, st: _MatrixState) -> float:
        x = self.service.solver(mid).solve(torch.as_tensor(
            st.canary, device=self.device)).cpu().numpy()
        if not np.all(np.isfinite(x)):
            st.last_canary = float("inf")
            return float("inf")
        resid = float(np.linalg.norm(st.a @ x - st.canary) / st.canary_norm)
        st.last_canary = resid
        return resid

    def _matrix_healthy(self, mid: str, st: _MatrixState) -> bool:
        return self._canary_residual(mid, st) <= st.trip

    def _quarantine_and_recover(self, mid: str,
                                replay: List[_Request]) -> None:
        """The ladder: quarantine -> re-program (fresh key, write-verify
        on) -> replay; degrade to digital when health can't be restored."""
        st = self._matrix[mid]
        self.stats.quarantines += 1
        t0 = time.monotonic()
        log.warning("quarantining %r (canary residual over %.2e)",
                    mid, st.trip)
        recovered = False
        for _ in range(self.max_reprograms):
            st.reprograms += 1
            self.stats.reprograms += 1
            key = keys.fold_in(st.base_key, st.reprograms)
            ni = self.recovery_nonideal
            if ni is None:
                # default recovery config: the programming-time
                # mitigations the physics subsystem models - write-verify
                # (IR-drop pre-distortion) + fault-aware remapping
                ni = dataclasses.replace(st.base_cfg.nonideal,
                                         compensate_wire=True,
                                         remap_faults=True)
            if self.chaos is not None:
                ni = self.chaos.reprogram_nonideal(mid, ni)
            self.service.program(mid, st.a, keys.generator(key),
                                 cfg=st.base_cfg.with_(nonideal=ni))
            with self._lock:
                st.sig = self.service.signature(mid)
            # whole-matrix re-program: every array is fresh, so the old
            # maintenance state (ages, trends, baselines) is void
            self._init_maint(mid, st)
            if self._matrix_healthy(mid, st):
                recovered = True
                break
        self.stats.recovery_s.append(time.monotonic() - t0)
        if recovered:
            with self._lock:
                st.status = "healthy"
            log.warning("recovered %r after %d re-program(s) in %.3fs",
                        mid, st.reprograms, self.stats.recovery_s[-1])
            if replay:
                self.stats.replays += len(replay)
                self._replay(mid, replay)
        else:
            with self._lock:
                st.status = "degraded"
            self.stats.degraded += 1
            log.error("could not restore %r after %d re-programs; "
                      "degrading to digital fallback", mid,
                      self.max_reprograms)
            if replay:
                self.stats.replays += len(replay)
                self._serve_fallback(mid, replay)

    def _replay(self, mid: str, reqs: List[_Request]) -> None:
        """Re-dispatch withheld requests against freshly programmed
        arrays (still inside the current cycle: recovery + replay happen
        before any later flush fires).  Replays get the same retry ladder
        as regular dispatches - a transient error here must not demote a
        just-recovered tenant to the digital path."""
        for r in reqs:
            self.service.submit(mid, r.b)
        attempts = [0]

        def attempt():
            attempts[0] += 1
            idx = self._next_dispatch_index()
            if self.chaos is not None:
                self.chaos.on_dispatch(idx, replica=self.name)
            with self._watchdog:
                return self.service.flush(mid).cpu().numpy()

        try:
            xs = retry_step(
                attempt, retries=self.retries, backoff=self.backoff,
                on_retry=lambda i, e: self._count_retry(e))
        except Exception:                              # noqa: BLE001
            self.service.discard_pending(mid)
            self._serve_fallback(mid, reqs)
            return
        for j, r in enumerate(reqs):
            self._resolve(r, xs[:, j], "analog", attempts[0])

    def _serve_fallback(self, mid: str, reqs: List[_Request]) -> None:
        """Digital-only degraded mode: one fused fallback solve, answers
        tagged mode="digital"."""
        try:
            bs = torch.as_tensor(np.stack([r.b for r in reqs], axis=1),
                                 device=self.device)
            idx = self._next_dispatch_index()
            if self.chaos is not None:
                self.chaos.on_dispatch(idx, replica=self.name)
            with self._watchdog:
                xs = self.service.solve_fallback(
                    mid, bs, **self.fallback_kw).cpu().numpy()
            self.stats.fallback_rhs += len(reqs)
            for j, r in enumerate(reqs):
                self._resolve(r, xs[:, j], "digital", 1)
        except ReplicaDeathError:
            raise                   # hard death: futures stay for replay
        except BaseException as e:                     # noqa: BLE001
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)

    # -- drift maintenance (worker thread only) --------------------------
    #
    # The background scrubber of the maintenance subsystem (DESIGN note in
    # serve/maintenance.py).  Counter discipline: probes and repairs bump
    # `_maint_count`, NEVER `_next_dispatch_index` - a chaos trace replays
    # identically with scrubbing on or off (tests/test_maintenance.py).

    def _wake(self) -> None:
        """DeviceClock subscriber: nudge an idle worker to scrub."""
        with self._work:
            self._work.notify_all()

    def _init_maint(self, matrix_id: str, st: _MatrixState) -> None:
        """(Re)build per-matrix maintenance state after any full program.

        Maintenance needs a device clock, a drift model to age under, and
        a solver retaining its flat plan + partitioned system (checkpoint-
        restored solvers fall back to the reactive ladder)."""
        st.maint = None
        if self.clock is None:
            return
        solver = self.service.solver(matrix_id)
        if not getattr(solver, "repairable", False):
            return
        if self.service.matrix_cfg(matrix_id).nonideal.drift_nu == 0.0:
            return
        st.maint = MatrixMaintenance(solver, self.maintenance,
                                     self.clock.now())

    def _repair_allowed(self) -> bool:
        gate = self.repair_gate
        return gate is None or bool(gate())

    def _maint_due(self) -> bool:
        """Wait-predicate hook (called with the engine lock held - the
        repair gate must therefore be lock-free).  Age syncing for
        non-scrubbing engines happens lazily at dispatch instead, so a
        reactive baseline never wakes for maintenance."""
        if self.clock is None or not self.scrub_on:
            return False
        t = self.clock.now()
        for st in self._matrix.values():
            m = st.maint
            if m is None:
                continue
            if m.synced_at != t or m.backlog(t) > 0:
                return True
            if m.pending and self._repair_allowed():
                return True
        return False

    def _sync_clock(self) -> None:
        """Re-finalize every clock-tracked plan at current device ages
        (cheap no-op while the clock has not moved)."""
        if self.clock is None:
            return
        t = self.clock.now()
        with self._lock:
            items = list(self._matrix.items())
        for mid, st in items:
            if st.maint is not None and st.maint.synced_at != t:
                self._refresh_ages(mid, st, t)

    def _refresh_ages(self, mid: str, st: _MatrixState, t: float) -> None:
        m = st.maint
        solver = self.service.solver(mid)
        self.service.refresh(mid, solver.aged(m.plan_ages(solver.flat, t)))
        m.synced_at = t
        self.stats.age_refreshes += 1

    def _maintenance_cycle(self) -> None:
        """One idle maintenance pass: sync ages, probe a few blocks per
        matrix, repair what is (predicted to be) degrading.  Maintenance
        failures never take serving down: a matrix whose maintenance path
        breaks drops back to the reactive canary ladder."""
        if self.clock is None:
            return
        t = self.clock.now()
        with self._lock:
            items = list(self._matrix.items())
        for mid, st in items:
            m = st.maint
            if m is None:
                continue
            try:
                if m.synced_at != t:
                    self._refresh_ages(mid, st, t)
                if not self.scrub_on:
                    continue
                if m.backlog(t) > 0:
                    solver = self.service.solver(mid)
                    done = m.scrub(solver.flat, solver.cfg, t,
                                   self.maintenance.scrub_blocks_per_cycle)
                    self._maint_count += done
                    self.stats.scrub_probes += done
                if m.pending and self._repair_allowed():
                    self._do_repairs(mid, st, t)
            except ReplicaDeathError:
                raise
            except BaseException as e:                 # noqa: BLE001
                log.exception("maintenance for %r failed (%s); falling "
                              "back to the reactive ladder", mid, e)
                st.maint = None

    def _do_repairs(self, mid: str, st: _MatrixState, t: float) -> None:
        """Re-program just the scheduled blocks and splice them into the
        serving plan (`ProgrammedSolver.repaired`); cost scales with the
        degraded fraction, not n^2."""
        m = st.maint
        blocks = sorted(m.pending)[:self.maintenance.repair_batch]
        solver = self.service.solver(mid)
        if not solver.repairable:                      # pragma: no cover
            m.pending.clear()
            return
        m.repair_rounds += 1
        # fresh fold_in lineage, disjoint from the recovery (reprograms)
        # and chaos-fault (10_000+) key streams
        key = keys.fold_in(st.base_key, 20_000 + m.repair_rounds)
        repaired = solver.repaired(blocks, keys.generator(key))
        self.service.refresh(mid, repaired)
        m.note_repaired(blocks, repaired.flat, repaired.cfg, t)
        self._maint_count += 1
        self.stats.repairs += 1
        self.stats.blocks_repaired += len(blocks)
        log.info("repaired %d/%d block(s) of %r at device time %.3f",
                 len(blocks), len(m.refs), mid, t)
        if self.on_repair is not None:
            try:
                self.on_repair(mid, repaired, key)
            except Exception as e:                     # noqa: BLE001
                log.exception("on_repair callback for %r failed: %s",
                              mid, e)

    def _apply_aging_event(self, ev) -> None:
        """Chaos AcceleratedDrift / HotBlock: steepen the aging of a
        matrix (or one of its blocks) from now on.  Nothing is marked
        healthy/unhealthy here - the scrubber (or the canary) has to
        catch the consequences."""
        st = self._matrix.get(ev.matrix_id)
        if st is None or st.maint is None:
            return
        m = st.maint
        if isinstance(ev, HotBlock):
            ref = tuple(ev.block)
            m.block_scale[ref] = (m.block_scale.get(ref, 1.0)
                                  * float(ev.factor))
            log.warning("chaos: hot block %s in %r (x%g aging)",
                        ref, ev.matrix_id, ev.factor)
        else:
            m.age_scale *= float(ev.factor)
            log.warning("chaos: accelerated drift on %r (x%g aging)",
                        ev.matrix_id, ev.factor)
        m.synced_at = None            # force a re-bake at the new rates

    # -- bookkeeping -----------------------------------------------------

    def _apply_device_fault(self, ev) -> None:
        """Chaos DeviceFault: re-program the matrix's arrays under the
        faulty physics config (same dense target, deterministic key).
        The engine treats this exactly like silent hardware degradation -
        nothing is marked; the canary has to catch it."""
        st = self._matrix.get(ev.matrix_id)
        if st is None:
            return
        key = keys.fold_in(st.base_key, 10_000 + st.reprograms)
        self.service.program(
            ev.matrix_id, st.a, keys.generator(key),
            cfg=st.base_cfg.with_(nonideal=ev.nonideal))
        with self._lock:
            st.sig = self.service.signature(ev.matrix_id)
        self._init_maint(ev.matrix_id, st)
        log.warning("chaos: device fault injected into %r", ev.matrix_id)

    def _next_dispatch_index(self) -> int:
        idx = self._dispatch_count
        self._dispatch_count += 1
        self.stats.dispatches += 1
        return idx

    def _count_retry(self, e: BaseException) -> None:
        self.stats.retries += 1

    def _resolve(self, r: _Request, x: np.ndarray, mode: str,
                 attempts: int) -> None:
        now = time.monotonic()
        missed = r.deadline is not None and now > r.deadline
        if missed:
            self.stats.deadline_misses += 1
        st = self._matrix[r.matrix_id]
        self.stats.answered += 1
        r.future.set_result(SolveResult(
            x=np.array(x), matrix_id=r.matrix_id, mode=mode,
            health=st.status, reprograms=st.reprograms,
            latency_s=now - r.t_submit, deadline_missed=missed,
            dispatch_index=self._dispatch_count, attempts=attempts))
