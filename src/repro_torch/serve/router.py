"""Replicated serving fleet: health-scored routing, hedging, durable recovery,
as in `repro/serve/router.py`.

`ReplicatedSolverFleet` is the multi-replica layer over
`AsyncSolverEngine`: N engine replicas, each with its own `SolverService`,
worker thread and device slot via `ElasticMesh.assign_replicas` (every
card of the host by default; on one card every replica shares it, and
the card runs their launches one after another), behind a router that
owns admission, placement, hedging and failure recovery.

**Replicated programming.** `program` programs every matrix on every
replica with the *same* key.  Programming is deterministic in (matrix,
key, cfg) - each replica draws the noise from its own generator seeded
from the key (`keys.generator`) - so the conductance stacks are
bit-identical across replicas -
which is what makes three things free: any replica can answer any
request, any survivor is a valid pytree template for checkpoint restore
(stackability invariant), and replayed requests get the same answers the
dead replica would have produced.

**Health-scored routing.** Each replica carries an EWMA composite score:
canary-residual ratio (current residual / calibrated trip - the physics
signal), deadline-miss rate (the SLO signal), and queue depth (the load
signal).  Lower is healthier.  Placement is least-loaded with
signature-affinity: same-signature requests prefer the replica already
accumulating that signature's batch (packed dispatch efficiency), unless
its score has fallen behind the best replica by more than
`affinity_slack`.

**Hedged requests.** A deadline-critical submit (`hedge=True`, or any
deadlined submit when `hedge_delay` is set) arms a timer: if the primary
leg has not answered after the hedge delay, a duplicate leg goes to the
next-best replica.  First finite answer wins the outer future; the
losing leg is cancelled if still queued (`engine.cancel`) and its answer
is ignored otherwise.  A hedge turns a straggling replica from a tail
latency event into one wasted dispatch.

**Lifecycle ladder.** degraded -> drained -> quarantined -> replaced:
a replica whose health (the score without its load term: canary ratio
and miss rate) crosses `degrade_score` is deprioritized (routing order);
past `drain_score` it is drained (no new requests); a drained
replica whose in-flight work has settled (or that overstays
`drain_grace`) is quarantined - its engine is stopped, every leg still
unresolved is replayed on survivors - and replaced.  A replica whose
worker *dies* (chaos `ReplicaDeath`, or anything else that kills the
thread) skips the ladder: the monitor detects the dead worker, replays
every outstanding leg on the survivors immediately (no future ever
hangs; the replays are the only requests that can miss deadlines, so
tenants routed to healthy replicas see zero misses), and then rebuilds
the replica.  (The monitor replaces a dead replica however its death was
first noticed: the reference skips one that a submit found dead first,
and that replica's queued legs then never replay.  And queue depth only
ranks replicas: the reference's ladder reads the whole score, so a load
surge that deepens every queue - a replacement's recovery stalling the
survivors - drains every healthy replica and the fleet refuses all
traffic with `NoReplicaAvailableError`.)

**Durable recovery.** Replacement programming is the expensive path -
write-verify analog programming is exactly the cost the paper's
program-once/solve-many economics amortize away.  With a `ProgramStore`
attached, `program` persists each matrix's programmed state (FinalizedPlan
+ ArenaPlan, keyed by plan_signature + program key + matrix hash, with
the calibrated canary trip in the manifest); a replacement replica
*restores* stacks from the checkpoint and re-validates them against the
ORIGINAL trip threshold (`engine.install`).  Only when the checkpoint is
stale (signature/hash/key mismatch), corrupt (manifest cross-check), or
physically bad (canary rejection) does it fall back to full
re-programming.  Restore-vs-reprogram times are recorded per recovery in
`FleetStats` - the re-program / restore ratio a fleet's recovery is
judged by.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import keys
from repro_torch.checkpoint.ckpt import CheckpointError
from repro_torch.checkpoint.program_store import (CheckpointRejectedError,
                                                  ProgramStore,
                                                  StaleCheckpointError)
from repro_torch.device import device_scope
from repro_torch.runtime.elastic import ElasticMesh
from repro_torch.serve.async_engine import (AsyncSolverEngine,
                                            EngineStoppedError, SolveResult)
from repro_torch.serve.solver_service import _host

log = logging.getLogger("repro_torch.serve.router")


class FleetError(RuntimeError):
    """Base class for fleet-surfaced request failures."""


class NoReplicaAvailableError(FleetError):
    """No live replica can take this request (total fleet loss)."""


@dataclasses.dataclass
class FleetStats:
    """Fleet-lifetime counters (monitor/handler-written; read quiesced)."""
    submitted: int = 0
    answered: int = 0
    hedges: int = 0            # hedge legs launched
    hedge_wins: int = 0        # outer answered by a hedge leg
    cancelled_legs: int = 0    # losing legs cancelled while queued
    replays: int = 0           # legs replayed on a survivor
    deaths: int = 0           # replicas whose worker died
    drains: int = 0
    quarantines: int = 0
    replacements: int = 0
    restores: int = 0          # recoveries served from checkpoint
    reprogram_fallbacks: int = 0   # recoveries that had to re-program
    rejected_checkpoints: int = 0  # stale/corrupt/canary-failed restores
    repairs: int = 0           # block-repair rounds across the fleet
    recheckpoints: int = 0     # repaired plans persisted to the store
    maintenance_windows: int = 0   # repair-token grants (staggered)
    restore_s: List[float] = dataclasses.field(default_factory=list)
    reprogram_s: List[float] = dataclasses.field(default_factory=list)


class _Score:
    """Per-replica EWMA health composite; lower is healthier."""

    __slots__ = ("alpha", "canary", "miss", "queue")

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.canary = 0.0      # EWMA of canary residual / trip threshold
        self.miss = 0.0        # EWMA of deadline-miss indicator
        self.queue = 0.0       # latest queue depth (instant, not EWMA)

    def _ewma(self, old: float, x: float) -> float:
        return (1.0 - self.alpha) * old + self.alpha * x

    def observe_answer(self, missed: bool) -> None:
        self.miss = self._ewma(self.miss, 1.0 if missed else 0.0)

    def observe_health(self, canary_ratio: float, queue_depth: int,
                       max_batch: int) -> None:
        self.canary = self._ewma(self.canary, min(canary_ratio, 10.0))
        self.queue = queue_depth / max(1, max_batch)

    def health(self) -> float:
        """The ladder's input: the physics and SLO signals, not load."""
        return self.canary + 2.0 * self.miss

    def value(self) -> float:
        """The routing rank: health plus the load signal."""
        return self.health() + 0.25 * self.queue


class _FleetRequest:
    __slots__ = ("matrix_id", "b", "deadline", "future", "t_submit",
                 "legs", "failures", "replicas_tried", "hedged")

    def __init__(self, matrix_id: str, b: np.ndarray,
                 deadline: Optional[float], future: Future,
                 t_submit: float):
        self.matrix_id = matrix_id
        self.b = b
        self.deadline = deadline       # absolute monotonic, or None
        self.future = future           # the caller-facing outer future
        self.t_submit = t_submit
        self.legs: List[Future] = []   # live inner futures
        self.failures: List[BaseException] = []
        self.replicas_tried: List[str] = []
        self.hedged = False


class _Replica:
    __slots__ = ("name", "device", "engine", "generation", "state",
                 "score", "inflight", "drained_at")

    def __init__(self, name: str, device, engine: AsyncSolverEngine,
                 alpha: float):
        self.name = name
        self.device = device
        self.engine = engine
        self.generation = 0
        self.state = "active"   # active|degraded|drained|quarantined|dead
        self.score = _Score(alpha)
        self.inflight: Dict[Future, _FleetRequest] = {}
        self.drained_at: Optional[float] = None

    @property
    def routable(self) -> bool:
        return self.state in ("active", "degraded")


@dataclasses.dataclass
class _MatrixRecord:
    a: np.ndarray
    key: np.ndarray        # the reference's (2,) uint32 key
    cfg: object            # AnalogConfig or None (service default)
    sig: tuple
    trip: float


class ReplicatedSolverFleet:
    """N health-scored `AsyncSolverEngine` replicas behind one router.

    `make_service` is a zero-argument factory producing a fresh
    `SolverService` per replica (and per replacement) - replicas must
    never share mutable service state.  The fleet calls it with the
    replica's card current, so a service made on "cuda" lands on that
    card; `devices=[torch.device("cpu")]` with host services runs the
    fleet on the host.  `engine_kw` forwards to every `AsyncSolverEngine`;
    the fleet adds `name`, `device` and `chaos` itself.
    """

    def __init__(self, make_service: Callable[[], object],
                 n_replicas: int = 2, *,
                 engine_kw: Optional[dict] = None,
                 store: Optional[ProgramStore] = None,
                 mesh: Optional[ElasticMesh] = None,
                 devices: Optional[list] = None,
                 chaos=None,
                 clock=None,
                 hedge_delay: Optional[float] = None,
                 affinity_slack: float = 0.5,
                 ewma_alpha: float = 0.3,
                 degrade_score: float = 0.8,
                 drain_score: float = 1.5,
                 drain_grace: float = 0.25,
                 poll_interval: float = 0.002):
        if n_replicas < 1:
            raise ValueError("fleet needs at least one replica")
        self.make_service = make_service
        self.engine_kw = dict(engine_kw or {})
        self.store = store
        self.chaos = chaos
        self.clock = clock            # shared DeviceClock (drift aging)
        self.hedge_delay = hedge_delay
        self.affinity_slack = float(affinity_slack)
        self.ewma_alpha = float(ewma_alpha)
        self.degrade_score = float(degrade_score)
        self.drain_score = float(drain_score)
        self.drain_grace = float(drain_grace)
        self.poll_interval = float(poll_interval)
        self.stats = FleetStats()

        # maintenance staggering: at most ONE replica holds the repair
        # token at a time, so scrub/repair windows never overlap across
        # the fleet (the goodput invariant).  The token is a plain
        # attribute read lock-free by each engine's repair gate.
        self._repair_token: Optional[str] = None
        self._maint_rotor = 0

        placement = (mesh or ElasticMesh()).assign_replicas(
            n_replicas, devices)
        self._lock = threading.RLock()
        self._replicas: List[_Replica] = [
            self._make_replica(f"r{i}", placement[i])
            for i in range(n_replicas)]
        self._matrices: Dict[str, _MatrixRecord] = {}
        self._affinity: Dict[tuple, str] = {}   # sig -> replica name
        self._submits = 0                       # chaos corruption counter
        self._running = False
        self._monitor: Optional[threading.Thread] = None
        self._timers: List[threading.Timer] = []

    def _make_replica(self, name: str, device) -> _Replica:
        kw = dict(self.engine_kw)
        if self.clock is not None:
            # thread the shared device clock through every replica; the
            # repair gate reads the token without any lock (it runs
            # inside the engine's wait predicate), and on_repair
            # re-checkpoints repaired plans
            kw.setdefault("clock", self.clock)
            kw.setdefault("repair_gate",
                          lambda name=name: self._repair_token == name)
            kw.setdefault("on_repair",
                          lambda mid, solver, key, name=name:
                          self._on_repair(name, mid, solver, key))
        with device_scope(device):
            service = self.make_service()
        engine = AsyncSolverEngine(service, name=name,
                                   device=device, chaos=self.chaos,
                                   **kw)
        return _Replica(name, device, engine, self.ewma_alpha)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "ReplicatedSolverFleet":
        with self._lock:
            if self._running:
                raise RuntimeError("fleet already running")
            self._running = True
            for r in self._replicas:
                r.engine.start()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="amc-fleet-monitor",
                                         daemon=True)
        self._monitor.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = 10.0):
        with self._lock:
            self._running = False
            timers, self._timers = self._timers, []
        for t in timers:
            t.cancel()
        if self._monitor is not None:
            self._monitor.join(timeout)
            self._monitor = None
        for r in self._replicas:
            if r.engine.alive:
                r.engine.stop(drain=drain, timeout=timeout)

    def __enter__(self) -> "ReplicatedSolverFleet":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop(drain=exc_type is None)
        return False

    # ------------------------------------------------------------------
    # programming + durability
    # ------------------------------------------------------------------

    def program(self, matrix_id: str, a, key=None, cfg=None) -> None:
        """Program `a` on EVERY replica under the same key, then persist.

        Same key => bit-identical programmed stacks on every replica (the
        replicated-programming invariant above).  With a store attached,
        replica r0's solver is checkpointed together with the calibrated
        canary trip, so a future replacement can restore instead of
        re-program."""
        key = keys.as_key(key) if key is not None else keys.PRNGKey(0)
        a_host = _host(a)
        with self._lock:
            replicas = [r for r in self._replicas if r.state != "dead"]
        if not replicas:
            raise NoReplicaAvailableError("no live replica to program")
        for r in replicas:
            r.engine.program(matrix_id, a, key, cfg=cfg)
        lead = replicas[0]
        sig = lead.engine.service.signature(matrix_id)
        trip = lead.engine.matrix_trip(matrix_id)
        with self._lock:
            self._matrices[matrix_id] = _MatrixRecord(
                a_host, key, cfg, sig, trip)
        if self.store is not None:
            self.store.save(matrix_id, lead.engine.service.solver(matrix_id),
                            a_host, key, sig, extra={"trip": float(trip)})

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def _pick(self, sig: tuple,
              exclude: Tuple[str, ...] = ()) -> _Replica:
        """Least-loaded routable replica, with signature affinity: the
        replica already accumulating this signature keeps it while its
        score stays within `affinity_slack` of the best candidate.

        Ranking quantizes the health score (quarter-point buckets) before
        load and assignment count: sub-noise EWMA differences - e.g. the
        replica programmed last having seen fewer canary observations -
        must not defeat least-loaded spreading.  The final assignment-
        count key round-robins *new* signatures across equally-healthy
        replicas, so a multi-tenant fleet spreads deterministically
        instead of piling onto whichever replica sorts first."""
        cands = [r for r in self._replicas
                 if r.routable and r.name not in exclude]
        if not cands:
            # hedging excludes the primary; a 1-replica fleet falls back
            cands = [r for r in self._replicas if r.routable]
        if not cands:
            raise NoReplicaAvailableError(
                "no routable replica (all drained, quarantined or dead)")
        assigned: Dict[str, int] = {}
        for name in self._affinity.values():
            assigned[name] = assigned.get(name, 0) + 1
        cands.sort(key=lambda r: (0 if r.state == "active" else 1,
                                  int(r.score.value() / 0.25),
                                  len(r.inflight),
                                  assigned.get(r.name, 0)))
        best = cands[0]
        aff = self._affinity.get(sig)
        if aff is not None and aff != best.name:
            for r in cands:
                if r.name == aff:
                    if (r.score.value() - best.score.value()
                            <= self.affinity_slack):
                        best = r
                    break
        self._affinity[sig] = best.name
        return best

    def submit(self, matrix_id: str, b, *,
               deadline_s: Optional[float] = None,
               hedge: Optional[bool] = None) -> Future:
        """Route one (n,) rhs; returns a Future[SolveResult].

        The outer future NEVER hangs: it resolves with the first finite
        answer from any leg, or with a typed error once every leg has
        failed and no survivor can take a replay."""
        with self._lock:
            if not self._running:
                raise FleetError("fleet is not running")
            rec = self._matrices[matrix_id]
            # pick FIRST: a fully-drained fleet must reject with
            # NoReplicaAvailableError before any counter moves, so a
            # failed admission leaves `stats`/`_submits` (and the chaos
            # corruption schedule keyed on `_submits`) untouched
            replica = self._pick(rec.sig)
            self._submits += 1
            now = time.monotonic()
            deadline = (None if deadline_s is None
                        else now + float(deadline_s))
            req = _FleetRequest(matrix_id, np.array(b), deadline,
                                Future(), now)
            self.stats.submitted += 1
            self._launch_leg(req, replica)
            do_hedge = (hedge if hedge is not None
                        else (self.hedge_delay is not None
                              and deadline is not None))
            if do_hedge and self.hedge_delay is not None:
                t = threading.Timer(self.hedge_delay, self._hedge, (req,))
                t.daemon = True
                if len(self._timers) > 256:     # prune fired timers
                    self._timers = [x for x in self._timers if x.is_alive()]
                self._timers.append(t)
                t.start()
        return req.future

    def _launch_leg(self, req: _FleetRequest, replica: _Replica,
                    replay: bool = False) -> None:
        """Submit one leg of `req` to `replica` (lock held by caller)."""
        deadline_s = None
        if req.deadline is not None:
            deadline_s = max(1e-4, req.deadline - time.monotonic())
        try:
            inner = replica.engine.submit(req.matrix_id, req.b,
                                          deadline_s=deadline_s)
        except EngineStoppedError:
            # raced a death the monitor hasn't seen yet: route elsewhere
            self._note_dead(replica)
            survivor = self._pick(self._matrices[req.matrix_id].sig,
                                  exclude=(replica.name,))
            self._launch_leg(req, survivor, replay=replay)
            return
        req.legs.append(inner)
        req.replicas_tried.append(replica.name)
        replica.inflight[inner] = req
        if replay:
            self.stats.replays += 1
        inner.add_done_callback(
            lambda fut, rep=replica: self._on_leg_done(rep, fut))

    def _hedge(self, req: _FleetRequest) -> None:
        """Timer body: duplicate an unanswered request to the next-best
        replica (first finite answer wins)."""
        with self._lock:
            if not self._running or req.future.done() or req.hedged:
                return
            req.hedged = True
            self.stats.hedges += 1
            try:
                replica = self._pick(self._matrices[req.matrix_id].sig,
                                     exclude=tuple(req.replicas_tried))
            except (NoReplicaAvailableError, KeyError):
                return
            self._launch_leg(req, replica)
            replica.engine.flush_now()

    # ------------------------------------------------------------------
    # leg settlement
    # ------------------------------------------------------------------

    def _on_leg_done(self, replica: _Replica, inner: Future) -> None:
        with self._lock:
            req = replica.inflight.pop(inner, None)
            if req is None:
                return
            if inner.cancelled():
                return
            exc = inner.exception()
            if exc is not None:
                self._leg_failed(req, replica, inner, exc)
                return
            res: SolveResult = inner.result()
            replica.score.observe_answer(res.deadline_missed)
            x = np.asarray(res.x)
            if not np.all(np.isfinite(x)):
                self._leg_failed(req, replica, inner, FleetError(
                    f"non-finite answer from replica {replica.name!r}"))
                return
            try:
                req.future.set_result(res)
            except InvalidStateError:
                return                      # a sibling leg won the hedge
            self.stats.answered += 1
            if len(req.replicas_tried) > 1 and \
                    req.replicas_tried.index(replica.name) > 0:
                self.stats.hedge_wins += 1
            # the winner settles the race: cancel still-queued siblings
            for leg in req.legs:
                if leg is inner or leg.done():
                    continue
                for other in self._replicas:
                    if leg in other.inflight:
                        if other.engine.cancel(leg):
                            self.stats.cancelled_legs += 1
                        break

    def _leg_failed(self, req: _FleetRequest, replica: _Replica,
                    inner: Future, exc: BaseException) -> None:
        """One leg failed (lock held).  Replica death reroutes; anything
        else surfaces once no sibling leg can still answer."""
        req.failures.append(exc)
        if req.future.done():
            return
        if isinstance(exc, EngineStoppedError):
            try:
                survivor = self._pick(self._matrices[req.matrix_id].sig,
                                      exclude=(replica.name,))
                self._launch_leg(req, survivor, replay=True)
                return
            except NoReplicaAvailableError as e:
                exc = e
        if any(not leg.done() for leg in req.legs):
            return                          # a sibling may still answer
        try:
            req.future.set_exception(exc)
        except InvalidStateError:
            pass

    # ------------------------------------------------------------------
    # supervision: monitor loop, lifecycle ladder, death + replacement
    # ------------------------------------------------------------------

    def _monitor_loop(self) -> None:
        while True:
            with self._lock:
                if not self._running:
                    return
            try:
                self.review()
            except Exception:               # noqa: BLE001
                log.exception("fleet review failed")
            time.sleep(self.poll_interval)

    def review(self) -> None:
        """One supervision pass (the monitor calls this continuously;
        tests call it directly for determinism): scripted checkpoint
        corruption, health-score refresh, the lifecycle ladder, and
        dead-worker recovery."""
        if self.chaos is not None and self.store is not None:
            with self._lock:
                due = self.chaos.corruptions_due(self._submits)
            for ev in due:
                try:
                    self.store.corrupt(ev.matrix_id, ev.how)
                    log.warning("chaos: corrupted checkpoint of %r (%s)",
                                ev.matrix_id, ev.how)
                except CheckpointError:
                    pass                    # nothing stored yet
        to_replace: List[_Replica] = []
        with self._lock:
            if self.clock is not None:
                self._rotate_repair_token()
            for r in self._replicas:
                if r.state == "quarantined":
                    continue
                if r.state == "dead" or not r.engine.alive:
                    # a death the submit path noted first (`_launch_leg`)
                    # is replaced here too: its orphaned legs must replay
                    self._note_dead(r)
                    to_replace.append(r)
                    continue
                snap = r.engine.health_snapshot()
                trips = snap["trip"]
                ratios = [snap["canary"][mid] / trips[mid]
                          for mid in snap["canary"] if trips[mid] > 0]
                r.score.observe_health(
                    max(ratios) if ratios else 0.0,
                    snap["queue_depth"],
                    max(1, r.engine.max_batch))
                health = r.score.health()
                if (self._repair_token == r.name
                        and r.state in ("active", "degraded")):
                    # the staggering invariant: a replica in its repair
                    # window is DEGRADED (deprioritized but routable) and
                    # is never drained or quarantined for the elevated
                    # canary its own maintenance causes
                    if r.state == "active":
                        r.state = "degraded"
                        log.info("replica %r degraded for maintenance "
                                 "window", r.name)
                    continue
                if r.state == "active" and health >= self.degrade_score:
                    r.state = "degraded"
                    log.warning("replica %r degraded (health %.2f)",
                                r.name, health)
                elif r.state == "degraded":
                    if health >= self.drain_score:
                        r.state = "drained"
                        r.drained_at = time.monotonic()
                        self.stats.drains += 1
                        log.warning("replica %r drained (health %.2f)",
                                    r.name, health)
                    elif health < 0.5 * self.degrade_score:
                        r.state = "active"
                elif r.state == "drained":
                    settled = not r.inflight
                    overstay = (r.drained_at is not None and
                                time.monotonic() - r.drained_at
                                > self.drain_grace)
                    if settled or overstay:
                        r.state = "quarantined"
                        self.stats.quarantines += 1
                        to_replace.append(r)
        for r in to_replace:
            self._quarantine_and_replace(r)

    def _rotate_repair_token(self) -> None:
        """Grant/release the fleet-wide repair token (lock held).

        Release when the holder is gone or has nothing left to repair;
        grant round-robin to the next routable replica with pending
        repairs, so maintenance windows stagger across the fleet instead
        of every replica repairing (and degrading) at once."""
        if self._repair_token is not None:
            holder = next((r for r in self._replicas
                           if r.name == self._repair_token), None)
            if (holder is None or not holder.engine.alive
                    or not holder.routable
                    or holder.engine.maintenance_pending == 0):
                self._repair_token = None
        if self._repair_token is None:
            n = len(self._replicas)
            for k in range(n):
                r = self._replicas[(self._maint_rotor + k) % n]
                if (r.routable and r.engine.alive
                        and r.engine.maintenance_pending > 0):
                    self._repair_token = r.name
                    self._maint_rotor = (self._replicas.index(r) + 1) % n
                    self.stats.maintenance_windows += 1
                    r.engine.flush_now()    # wake the worker to repair
                    break

    def _on_repair(self, name: str, mid: str, solver, key) -> None:
        """Engine on_repair callback (worker thread): count the round
        and persist the repaired plan, so a replacement replica restores
        post-repair stacks instead of pre-drift ones."""
        with self._lock:
            self.stats.repairs += 1
            rec = self._matrices.get(mid)
        if self.store is None or rec is None:
            return
        try:
            self.store.save(mid, solver, rec.a, rec.key, rec.sig,
                            extra={"trip": float(rec.trip)})
            with self._lock:
                self.stats.recheckpoints += 1
        except CheckpointError as e:
            log.warning("re-checkpoint of repaired %r failed: %s", mid, e)

    def _note_dead(self, replica: _Replica) -> None:
        """Mark a replica dead (lock held or reentrant)."""
        with self._lock:
            if replica.state == "dead":
                return
            replica.state = "dead"
            self.stats.deaths += 1
            log.error("replica %r is dead (worker lost)", replica.name)
            for sig, name in list(self._affinity.items()):
                if name == replica.name:
                    del self._affinity[sig]

    def _quarantine_and_replace(self, replica: _Replica) -> None:
        """Stop (if still up), replay every unresolved leg on survivors,
        rebuild the replica - restore from checkpoint when possible."""
        was_dead = replica.state == "dead"
        if not was_dead:
            with self._lock:
                replica.state = "quarantined"
                for sig, name in list(self._affinity.items()):
                    if name == replica.name:
                        del self._affinity[sig]
            try:
                # drain=False: unanswered legs resolve EngineStoppedError,
                # which _leg_failed turns into replays on survivors
                replica.engine.stop(drain=False, timeout=5.0)
            except RuntimeError:
                # worker stuck past the join timeout: treat as dead
                self._note_dead(replica)
        # legs a dead/stuck worker left unresolved never fire callbacks -
        # replay them explicitly (THE no-future-ever-hangs guarantee)
        with self._lock:
            orphans = [(inner, req) for inner, req in
                       list(replica.inflight.items())
                       if not inner.done()]
            replica.inflight.clear()
            for inner, req in orphans:
                if req.future.done():
                    continue
                try:
                    survivor = self._pick(
                        self._matrices[req.matrix_id].sig,
                        exclude=(replica.name,))
                except NoReplicaAvailableError as e:
                    try:
                        req.future.set_exception(e)
                    except InvalidStateError:
                        pass
                    continue
                self._launch_leg(req, survivor, replay=True)
        self._replace(replica)

    def _replace(self, replica: _Replica) -> None:
        """Rebuild a lost replica: fresh engine + service on the same
        device slot, programmed state restored from checkpoint when the
        store has a valid one, re-programmed from scratch otherwise."""
        with self._lock:
            if not self._running:
                return
            matrices = dict(self._matrices)
            survivors = [r for r in self._replicas
                         if r is not replica and r.state != "dead"
                         and r.engine.alive]
        fresh = self._make_replica(replica.name, replica.device)
        fresh.generation = replica.generation + 1
        fresh.engine.start()
        for mid, rec in matrices.items():
            self._recover_matrix(fresh, mid, rec, survivors)
        with self._lock:
            idx = self._replicas.index(replica)
            self._replicas[idx] = fresh
            self.stats.replacements += 1
        log.warning("replica %r replaced (generation %d)",
                    fresh.name, fresh.generation)

    def _recover_matrix(self, fresh: _Replica, mid: str,
                        rec: _MatrixRecord, survivors: List[_Replica]
                        ) -> None:
        """Restore-first recovery of one matrix onto a fresh replica."""
        if self.store is not None and self.store.has(mid) and survivors:
            template = survivors[0].engine.service.solver(mid)
            t0 = time.perf_counter()
            try:
                solver, meta = self.store.restore(
                    mid, template, rec.a, rec.key, rec.sig,
                    device=fresh.engine.device)
                trip = float(meta.get("trip", rec.trip))
                fresh.engine.install(mid, solver, rec.a, rec.key, trip,
                                     cfg=rec.cfg)
                self.stats.restores += 1
                self.stats.restore_s.append(time.perf_counter() - t0)
                return
            except (StaleCheckpointError, CheckpointRejectedError,
                    CheckpointError) as e:
                self.stats.rejected_checkpoints += 1
                log.warning("checkpoint restore of %r rejected (%s); "
                            "falling back to re-programming", mid, e)
        t0 = time.perf_counter()
        fresh.engine.program(mid, rec.a, rec.key, cfg=rec.cfg)
        self.stats.reprogram_fallbacks += 1
        self.stats.reprogram_s.append(time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def replica_states(self) -> Dict[str, str]:
        with self._lock:
            return {r.name: r.state for r in self._replicas}

    def replica_scores(self) -> Dict[str, float]:
        with self._lock:
            return {r.name: r.score.value() for r in self._replicas}

    def maintenance_gauges(self) -> Dict[str, dict]:
        """Per-replica drift gauges (report-only observability): each
        live replica's per-matrix maintenance summary plus its scrub /
        repair counters, as exported by `engine.health()`."""
        with self._lock:
            replicas = list(self._replicas)
        out: Dict[str, dict] = {}
        for r in replicas:
            if not r.engine.alive:
                continue
            snap = r.engine.health_snapshot()
            out[r.name] = {
                "maintenance": snap.get("maintenance", {}),
                "scrub_probes": snap.get("scrub_probes", 0),
                "repairs": snap.get("repairs", 0),
                "blocks_repaired": snap.get("blocks_repaired", 0),
            }
        return out

    def maintenance_quiesce(self, timeout: float = 30.0) -> bool:
        """Wait until every live replica's scrubber has caught up with
        the device clock.  The repair token is granted by the monitor
        one replica at a time, so this also waits out the staggered
        repair windows."""
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._lock:
                replicas = [r for r in self._replicas if r.engine.alive]
            busy = any(r.engine.maintenance_pending > 0 for r in replicas)
            if not busy:
                done = all(
                    r.engine.maintenance_quiesce(timeout=0.01)
                    for r in replicas)
                if done:
                    return True
            time.sleep(self.poll_interval)
        return False

    def flush_now(self) -> None:
        with self._lock:
            replicas = list(self._replicas)
        for r in replicas:
            if r.engine.alive:
                r.engine.flush_now()

    @property
    def matrix_ids(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._matrices)
