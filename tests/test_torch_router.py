"""The port's `ReplicatedSolverFleet` (TESTING.md "Replicated serving",
contracts 1-5; contract 6 is in test_torch_checkpoint.py).

* Routing against the reference: for one scripted sequence of health
  observations, queue depths, states and exclusions, `_pick` chooses the
  same replicas as the JAX fleet's (pure Python) and the health scores
  are equal.
* Replicated programming: every replica's conductance and operator
  stacks are bit-identical (the key seeds a fresh generator on each).
* Hedging, the lifecycle ladder, replica death with replay on the
  survivors (the acceptance scenario: 3 replicas, 3 tenants, a scripted
  `ReplicaDeath` mid-traffic, every future accurate, the replacement
  restored from the store), and corrupted or stale stores falling back
  to re-programming.

Chaos keys on dispatch (or, for checkpoint damage, submit) counters;
waits are bounded polls on fleet counters; nothing asserts a latency.
"""
import time

import jax
import numpy as np
import pytest
import torch

from repro.core.analog import AnalogConfig as JCfg
from repro.core.nonideal import NonidealConfig as JNi
from repro.serve import NoReplicaAvailableError as JNoReplica
from repro.serve import ReplicatedSolverFleet as JFleet
from repro.serve import SolverService as JService
from repro_torch import keys
from repro_torch.checkpoint import ProgramStore
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.core import blockamc as tb
from repro_torch.runtime import (ChaosInjector, CheckpointCorruption,
                                 ReplicaDeath, ReplicaStall)
from repro_torch.serve import (DeviceClock, FleetError, MaintenanceConfig,
                               NoReplicaAvailableError,
                               ReplicatedSolverFleet, SolverService)
from _torch_parity import torch_cfg

N = 16
JCFG = JCfg(array_size=8, nonideal=JNi(sigma=0.02))
TCFG = torch_cfg(JCFG)
KEY = keys.PRNGKey(7)
ANALOG_RES = 0.8        # raw analog answers at sigma 0.02: ~0.1-0.2
SOLVE_REL_TOL = 1e-4    # a served answer vs its plan's plain path
ENGINE_KW = dict(flush_interval=0.004, max_batch=4)
HOST = [torch.device("cpu")]


def _service(cfg=TCFG, stages=1):
    return lambda: SolverService(cfg, stages=stages, device="cpu")


def _fleet(n, **kw):
    kw.setdefault("engine_kw", ENGINE_KW)
    return ReplicatedSolverFleet(_service(), n, devices=HOST, **kw)


def _matrix(i):
    g = np.random.default_rng(300 + i).normal(size=(N, N))
    return (g @ g.T / N + np.eye(N)).astype(np.float32)


def _rhs(i):
    return np.random.default_rng(3000 + i).normal(size=N).astype(np.float32)


def _resid(a, x, b):
    return float(np.linalg.norm(a @ np.asarray(x) - b) / np.linalg.norm(b))


def _same_stacks(s0, s1):
    """Every leaf of two programmed solvers' {"fin", "arena"} trees, bit
    for bit."""
    t0 = list(flatten({"fin": s0.finalized, "arena": s0.arena}))
    t1 = list(flatten({"fin": s1.finalized, "arena": s1.arena}))
    assert [k for k, _ in t0] == [k for k, _ in t1]
    for (k, x0), (_, x1) in zip(t0, t1):
        assert torch.equal(x0, x1), k


def _assert_plain_answer(solver, b, x):
    """A served answer within SOLVE_REL_TOL of max|x| of `solver`'s plain
    path on the same rhs."""
    ref = tb.execute_arena(solver.arena, torch.from_numpy(b),
                           use_kernel=False).numpy()
    assert np.max(np.abs(np.asarray(x) - ref)) <= \
        SOLVE_REL_TOL * np.max(np.abs(ref))


def _wait(cond, timeout=20.0, poll=0.02):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if cond():
            return True
        time.sleep(poll)
    return False


# ----------------------------------------------- routing vs the reference --

def _script(fleet, sig_of, no_replica):
    """Drive `_pick` through scripted observations; the picks and scores.
    `no_replica` is the package's NoReplicaAvailableError."""
    picks = []
    steps = [
        ("pick", "A", ()), ("pick", "B", ()), ("pick", "C", ()),
        ("health", 0, 0.9, 3), ("answer", 1, True), ("pick", "D", ()),
        ("pick", "A", ()), ("inflight", 2, 3), ("pick", "E", ()),
        ("state", 1, "degraded"), ("pick", "B", ()), ("pick", "F", ("r0",)),
        ("health", 2, 0.1, 0), ("answer", 0, False), ("pick", "C", ()),
        ("state", 0, "drained"), ("pick", "A", ()), ("pick", "G", ("r2",)),
        ("health", 1, 4.0, 8), ("state", 1, "active"), ("pick", "B", ()),
        ("answer", 2, True), ("answer", 2, True), ("pick", "H", ()),
        ("state", 2, "dead"), ("state", 1, "quarantined"),
    ]
    for step in steps:
        reps = fleet._replicas
        if step[0] == "pick":
            picks.append(fleet._pick(sig_of(step[1]), exclude=step[2]).name)
        elif step[0] == "health":
            reps[step[1]].score.observe_health(step[2], step[3], 4)
        elif step[0] == "answer":
            reps[step[1]].score.observe_answer(step[2])
        elif step[0] == "inflight":
            for j in range(step[2]):
                reps[step[1]].inflight[object()] = None
        else:
            reps[step[1]].state = step[2]
        picks.append(tuple(round(r.score.value(), 12) for r in reps))
    with pytest.raises(no_replica):
        fleet._pick(sig_of("A"))
    return picks


def test_pick_sequence_equals_the_reference():
    jfleet = JFleet(lambda: JService(JCFG, stages=1), 3,
                    engine_kw=ENGINE_KW, ewma_alpha=0.5)
    tfleet = _fleet(3, ewma_alpha=0.5)
    # signatures are opaque to the router: any hashable per tenant
    assert _script(tfleet, lambda t: ("sig", t), NoReplicaAvailableError) \
        == _script(jfleet, lambda t: ("sig", t), JNoReplica)


# ---------------------------------------------- contract 1: replication --

def test_fleet_serves_spreads_and_replicates_bit_identically(tmp_path):
    store = ProgramStore(str(tmp_path))
    mats = {f"m{i}": _matrix(i) for i in range(2)}
    fleet = _fleet(2, store=store)
    with fleet:
        for i, (mid, a) in enumerate(mats.items()):
            # m1 under its own config: two signatures, which spread
            cfg = TCFG.with_(nonideal=TCFG.nonideal.__class__(sigma=0.03)) \
                if i else None
            fleet.program(mid, torch.from_numpy(a), keys.fold_in(KEY, i),
                          cfg=cfg)
        assert sorted(fleet.matrix_ids) == sorted(store.matrix_ids()) == \
            sorted(mats)
        for mid in mats:
            _same_stacks(*[r.engine.service.solver(mid)
                           for r in fleet._replicas])
        futs = []
        for w in range(3):
            for mid in mats:
                b = _rhs(10 * w + len(futs))
                futs.append((mid, b, fleet.submit(mid, b)))
            fleet.flush_now()
        for mid, b, fut in futs:
            res = fut.result(timeout=30)
            assert _resid(mats[mid], res.x, b) < ANALOG_RES
            assert not res.deadline_missed
        used = {r.name for r in fleet._replicas if r.engine.stats.answered}
    assert used == {"r0", "r1"}              # one signature a replica
    assert fleet.stats.answered == len(futs)
    assert fleet.stats.deaths == 0 and fleet.stats.replays == 0


def test_fleet_submit_validation_and_device_checks():
    fleet = _fleet(1)
    with pytest.raises(FleetError):           # not running yet
        fleet.submit("m", np.zeros(N, np.float32))
    with fleet:
        fleet.program("m", _matrix(0), KEY)
        with pytest.raises(KeyError):
            fleet.submit("nope", np.zeros(N, np.float32))
        with fleet._lock:
            fleet._replicas[0].state = "drained"
        before = (fleet.stats.submitted, fleet._submits)
        with pytest.raises(NoReplicaAvailableError):
            fleet.submit("m", np.zeros(N, np.float32))
        assert (fleet.stats.submitted, fleet._submits) == before
        with fleet._lock:
            fleet._replicas[0].state = "active"
    if not torch.cuda.device_count():
        with pytest.raises(ValueError):       # the default pool: no card
            ReplicatedSolverFleet(_service(), 2)
    with pytest.raises(ValueError):
        ReplicatedSolverFleet(_service(), 0, devices=HOST)


# -------------------------------------------------- contract 3: hedging --

def test_hedged_request_beats_a_stalled_replica():
    """r0 stalls 1.5 s on every dispatch; the hedge leg on r1 answers the
    outer future while the primary sleeps."""
    chaos = ChaosInjector([ReplicaStall(at_dispatch=0, seconds=1.5,
                                        replica="r0")])
    fleet = _fleet(2, chaos=chaos, hedge_delay=0.03)
    a = _matrix(3)
    with fleet:
        fleet.program("m", a, KEY)
        b = _rhs(4)
        res = fleet.submit("m", b, deadline_s=30.0, hedge=True).result(
            timeout=30)
        hedged = fleet.stats.hedges, fleet.stats.hedge_wins
    assert _resid(a, res.x, b) < ANALOG_RES and not res.deadline_missed
    assert hedged[0] >= 1 and hedged[1] >= 1
    assert chaos.fired >= 1                   # the stall really was armed


# ---------------------------------- contract 4: death, replay, recovery --

def test_replica_death_replay_and_checkpoint_restore(tmp_path):
    """The acceptance scenario: 3 replicas, 3 tenants, r0's worker dies at
    its dispatch 1 mid-traffic.  Every future resolves with an accurate
    answer and no deadline miss, the dead replica's legs replay on the
    survivors, and the replacement restores all three matrices.  The
    replicas' and the restored stacks equal r0's original bit for bit, so
    each answer, whichever replica gave it, is held to r0's original
    plan's plain path within SOLVE_REL_TOL of max|x|."""
    store = ProgramStore(str(tmp_path))
    chaos = ChaosInjector([ReplicaDeath(at_dispatch=1, replica="r0")])
    mats = {f"m{i}": _matrix(10 + i) for i in range(3)}
    fleet = _fleet(3, store=store, chaos=chaos)
    with fleet:
        for i, (mid, a) in enumerate(mats.items()):
            fleet.program(mid, a, keys.fold_in(KEY, 200 + i))
        original = {mid: fleet._replicas[0].engine.service.solver(mid)
                    for mid in mats}
        for r in fleet._replicas[1:]:
            for mid in mats:
                _same_stacks(original[mid], r.engine.service.solver(mid))
        futs = []
        for wave in range(4):
            for mid in mats:
                for j in range(3):
                    b = _rhs(100 * wave + 10 * j + len(futs))
                    futs.append((mid, b,
                                 fleet.submit(mid, b, deadline_s=30.0)))
            fleet.flush_now()
            time.sleep(0.05)
        for mid, b, fut in futs:
            res = fut.result(timeout=30)      # never hangs
            assert np.all(np.isfinite(res.x))
            assert _resid(mats[mid], res.x, b) < ANALOG_RES
            _assert_plain_answer(original[mid], b, res.x)
            assert not res.deadline_missed
        assert _wait(lambda: fleet.stats.replacements >= 1)
        assert set(fleet.replica_states().values()) == {"active"}
        fresh = fleet._replicas[0]
        assert fresh.generation == 1 and fresh.engine.alive
        for mid in mats:                      # restored bit for bit
            _same_stacks(original[mid], fresh.engine.service.solver(mid))
        b = _rhs(5)
        res = fleet.submit("m0", b).result(timeout=30)
        assert _resid(mats["m0"], res.x, b) < ANALOG_RES
        _assert_plain_answer(original["m0"], b, res.x)
        assert not fresh.engine.service.solver("m0").repairable  # restored
    assert chaos.fired >= 1
    assert fleet.stats.deaths == 1 and fleet.stats.replays >= 1
    assert fleet.stats.replacements == 1
    assert fleet.stats.restores == len(mats)
    assert fleet.stats.reprogram_fallbacks == 0
    assert fleet.stats.rejected_checkpoints == 0
    assert fleet.stats.answered == len(futs) + 1


def test_death_first_seen_by_a_submit_still_replays_and_replaces(tmp_path):
    """r0's worker dies with a leg queued, and the submit path notes the
    death (`_note_dead`, as `_launch_leg` does on EngineStoppedError)
    before the monitor looks: the monitor must still replay the orphaned
    leg and replace r0.  (The reference's monitor skips a replica already
    marked dead, so that leg never resolves.)  Holding the fleet lock
    keeps the monitor out until the death is noted."""
    chaos = ChaosInjector([ReplicaDeath(at_dispatch=0, replica="r0")])
    fleet = _fleet(2, store=ProgramStore(str(tmp_path)), chaos=chaos)
    a = _matrix(50)
    with fleet:
        fleet.program("m", a, keys.fold_in(KEY, 51))
        b = _rhs(52)
        with fleet._lock:
            fut = fleet.submit("m", b)
            r0 = fleet._replicas[0]
            assert r0.inflight and r0.name == "r0"
            r0.engine.flush_now()
            assert _wait(lambda: not r0.engine.alive)
            fleet._note_dead(r0)
        res = fut.result(timeout=30)
        assert _resid(a, res.x, b) < ANALOG_RES
        assert _wait(lambda: fleet.stats.replacements >= 1)
    assert fleet.stats.deaths == 1 and fleet.stats.replays == 1
    assert fleet.stats.restores == 1


def test_gray_failure_drains_quarantines_replaces(tmp_path):
    """A stalled-but-alive replica answers late; with alpha=1 the miss
    EWMA saturates and the ladder runs degraded -> drained -> quarantined
    -> replaced while the worker is alive.  The replacement restores."""
    store = ProgramStore(str(tmp_path))
    chaos = ChaosInjector([ReplicaStall(at_dispatch=0, seconds=1.0,
                                        until_dispatch=0, replica="r0")])
    fleet = _fleet(2, store=store, chaos=chaos, ewma_alpha=1.0,
                   drain_grace=0.05)
    a = _matrix(30)
    with fleet:
        fleet.program("m", a, keys.fold_in(KEY, 31))
        b = _rhs(32)
        res = fleet.submit("m", b, deadline_s=0.5).result(timeout=30)
        assert res.deadline_missed and _resid(a, res.x, b) < ANALOG_RES
        assert _wait(lambda: fleet.stats.replacements >= 1)
        assert set(fleet.replica_states().values()) == {"active"}
    assert fleet.stats.deaths == 0
    assert fleet.stats.drains >= 1 and fleet.stats.quarantines >= 1
    assert fleet.stats.restores >= 1


def test_a_deep_queue_ranks_a_replica_last_but_never_drains_it(
        monkeypatch):
    """Queue depth is load, not sickness: it ranks replicas for routing
    (contract 2) but does not move the lifecycle ladder, whose input is
    the canary ratio and the miss rate (contract 4).  (The reference's
    ladder reads the whole score, so a load surge drains every healthy
    replica and the fleet refuses all traffic.)"""
    fleet = _fleet(2)
    a = _matrix(40)
    with fleet:
        fleet.program("m", a, keys.fold_in(KEY, 41))
        r0 = fleet._replicas[0]
        snapshot = r0.engine.health_snapshot
        monkeypatch.setattr(r0.engine, "health_snapshot",
                            lambda: {**snapshot(), "queue_depth": 1000})
        for _ in range(3):
            fleet.review()
        assert fleet.replica_states() == {"r0": "active", "r1": "active"}
        assert r0.score.value() > fleet.drain_score > r0.score.health()
        assert fleet._pick(("sig", "new")).name == "r1"
        b = _rhs(42)
        res = fleet.submit("m", b).result(timeout=30)
    assert _resid(a, res.x, b) < ANALOG_RES
    assert fleet.stats.drains == 0 and fleet.stats.quarantines == 0


# --------------------------- contract 5: damaged stores fall back --------

def _death_recovery(store, chaos, damage):
    """2 replicas, 1 tenant, a scripted r0 death; `damage(store)` runs once
    "m" is programmed and saved.  Every future resolves accurately and
    the recovered fleet still serves."""
    a = _matrix(20)
    fleet = _fleet(2, store=store, chaos=chaos)
    with fleet:
        fleet.program("m", a, keys.fold_in(KEY, 21))
        damage(store)
        futs = []
        for wave in range(4):
            for j in range(3):
                b = _rhs(31 * wave + j)
                futs.append((b, fleet.submit("m", b)))
            fleet.flush_now()
            time.sleep(0.05)
        for b, fut in futs:
            assert _resid(a, fut.result(timeout=30).x, b) < ANALOG_RES
        assert _wait(lambda: fleet.stats.replacements >= 1)
        b = _rhs(6)
        assert _resid(a, fleet.submit("m", b).result(timeout=30).x,
                      b) < ANALOG_RES
    return fleet


def _stale(store):
    other = _matrix(99)
    key = keys.fold_in(KEY, 98)
    solver = tb.ProgrammedSolver.program(other, keys.generator(key), TCFG,
                                         1, device="cpu")
    store.save("m", solver, other, key, tb.plan_signature(N, 1, TCFG))


@pytest.mark.parametrize("damage", [
    lambda s: s.corrupt("m", how="values"),     # the canary rejects it
    lambda s: s.corrupt("m", how="truncate"),   # the manifest check
    _stale,                                     # the identity check
], ids=["values", "truncate", "stale"])
def test_damaged_checkpoint_falls_back_to_reprogram(tmp_path, damage):
    store = ProgramStore(str(tmp_path))
    chaos = ChaosInjector([ReplicaDeath(at_dispatch=1, replica="r0")])
    fleet = _death_recovery(store, chaos, damage)
    assert fleet.stats.deaths == 1
    assert fleet.stats.rejected_checkpoints >= 1
    assert fleet.stats.reprogram_fallbacks >= 1
    assert fleet.stats.restores == 0 and len(fleet.stats.reprogram_s) >= 1


def test_chaos_scripted_checkpoint_corruption(tmp_path):
    store = ProgramStore(str(tmp_path))
    chaos = ChaosInjector([
        CheckpointCorruption(at_dispatch=1, matrix_id="m", how="values"),
        ReplicaDeath(at_dispatch=2, replica="r0")])
    fleet = _death_recovery(store, chaos, lambda s: None)
    fired = [e for _, e in chaos.log if isinstance(e, CheckpointCorruption)]
    assert len(fired) == 1                    # fired exactly once
    assert fleet.stats.rejected_checkpoints >= 1
    assert fleet.stats.reprogram_fallbacks >= 1


# ------------------------------------------- staggered maintenance --------

def test_fleet_staggers_repairs_and_never_quarantines():
    clock = DeviceClock()
    cfg = TCFG.with_(nonideal=TCFG.nonideal.__class__(sigma=0.0,
                                                      drift_nu=0.05))
    fleet = ReplicatedSolverFleet(
        _service(cfg, stages=2), 2, devices=HOST, clock=clock,
        engine_kw=dict(flush_interval=0.01, health_floor=0.05,
                       maintenance=MaintenanceConfig(
                           scrub_blocks_per_cycle=16, block_trip=0.02,
                           repair_batch=16)))
    with fleet:
        fleet.program("m", _matrix(40), keys.fold_in(KEY, 41))
        for wave in range(5):
            clock.advance(0.6)
            assert fleet.maintenance_quiesce(60.0)
            futs = [fleet.submit("m", _rhs(10 * wave + j)) for j in range(4)]
            fleet.flush_now()
            for f in futs:
                assert np.all(np.isfinite(f.result(timeout=30).x))
        gauges = fleet.maintenance_gauges()
        states = fleet.replica_states()
    assert fleet.stats.maintenance_windows > 1 and fleet.stats.repairs > 0
    assert fleet.stats.quarantines == 0 and fleet.stats.deaths == 0
    assert all(d["repairs"] > 0 for d in gauges.values())
    assert all(s in ("active", "degraded") for s in states.values())
