"""The port's `PackedSolverScheduler` and `AsyncSolverEngine` against the
JAX package (TESTING.md "Serving robustness" contract).

* The scheduler's ticket -> answer mapping, its flush triggers and its
  pending counts equal the reference's for the same submissions, on plans
  JAX programmed and carried across (`interop.solver_from_numpy`,
  `SolverService.install`); answers at rtol 2e-4 of max|x| (arena form).
* With JAX-programmed plans installed in both engines the answers agree
  at rtol 2e-4, with the same serving metadata.
* Under one chaos schedule (a `DispatchException` at dispatch 3, a
  stuck-at `DeviceFault` on one tenant at 5) the firing log, the
  quarantines, re-programs, retries and replays and each result's mode
  and dispatch index equal the reference engine's exactly.  Noise cannot
  be replayed, so answers after a re-program are held to the float64
  solve: their relative residual stays within the tenant's trip.
* Contracts 1-5: every future resolves or fails typed; expiry and late
  answers; backpressure; the ladder down to the digital fallback; chaos
  determinism - plus the maintenance hooks (drift scrubbing on a device
  clock never consumes dispatch indices).

Chaos keys on the dispatch counter, never the wall clock; every future is
awaited with an explicit timeout; nothing asserts a latency.
"""
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.analog import AnalogConfig as JCfg
from repro.core.nonideal import NonidealConfig as JNi
from repro.runtime import chaos as jchaos
from repro.serve import AsyncSolverEngine as JEngine
from repro.serve import PackedSolverScheduler as JScheduler
from repro.serve import SolverService as JService
from repro_torch import interop, keys
from repro_torch.core.nonideal import NonidealConfig as TNi
from repro_torch.runtime import chaos as tchaos
from repro_torch.serve import (AsyncSolverEngine, BackpressureError,
                               DeadlineExceededError, DeviceClock,
                               EngineStoppedError, MaintenanceConfig,
                               PackedSolverScheduler, SolverService)
from _torch_parity import scaled_close, solver_dict, torch_cfg

N = 16
JCFG = JCfg(array_size=8, nonideal=JNi(sigma=0.02))
TCFG = torch_cfg(JCFG)
SEED = 5
# severe enough that no re-program key can pass the canary by luck
J_SEVERE = JNi(sigma=0.02, p_stuck_off=0.6, g_stuck_off=0.0)
T_SEVERE = TNi(sigma=0.02, p_stuck_off=0.6, g_stuck_off=0.0)
ANALOG_RES = 0.6        # raw analog answers at sigma 0.02: ~0.1-0.2


def _matrix(i, n=N):
    g = np.random.default_rng(100 + i).normal(size=(n, n))
    return (g @ g.T / n + np.eye(n)).astype(np.float32)


def _rhs(i, n=N):
    return np.random.default_rng(1000 + i).normal(size=n).astype(np.float32)


def _jkey(i):
    return jax.random.fold_in(jax.random.PRNGKey(SEED), i)


def _tkey(i):
    return keys.fold_in(keys.PRNGKey(SEED), i)


def _service(cfg=TCFG):
    return SolverService(cfg, stages=1, device="cpu")


def _program(eng, mids):
    for i, mid in enumerate(mids):
        eng.program(mid, _matrix(i), _tkey(100 + i))


def _residual(a, x, b):
    return float(np.linalg.norm(a.astype(np.float64) @ x - b)
                 / np.linalg.norm(b))


# ------------------------------------------------------------ scheduler ---

def test_scheduler_tickets_map_to_the_references_answers():
    mids = ["m0", "m1", "m2"]
    jsvc, tsvc = JService(JCFG, stages=1), _service()
    for i, mid in enumerate(mids):
        js = jsvc.program(mid, jnp.asarray(_matrix(i)), _jkey(i))
        tsvc.install(mid, interop.solver_from_numpy(
            solver_dict(js), TCFG, device="cpu"), _matrix(i))
    jsch, tsch = JScheduler(jsvc, max_batch=4), \
        PackedSolverScheduler(tsvc, max_batch=4)
    order = np.random.default_rng(0).choice(mids, size=11)
    tickets = []
    for step, mid in enumerate(order):
        b = _rhs(step)
        jt = jsch.submit(str(mid), jnp.asarray(b))
        tt = tsch.submit(str(mid), torch.from_numpy(b))
        assert tt == jt
        tickets.append(tt)
        assert [tsch.ready(x) for x in tickets] == \
            [jsch.ready(x) for x in tickets]
        assert tsch.pending() == jsch.pending()
        tsch.check_consistency()
    assert tsch.pending() == 3                  # 11 = 2 flushes of 4 + 3
    tsch.drain()
    jsch.drain()
    for x in tickets:
        scaled_close(tsch.result(x), np.asarray(jsch.result(x)), 2e-4)
    # a queue written behind the scheduler's back is refused, as in JAX
    for sch, svc, b in ((tsch, tsvc, torch.from_numpy(_rhs(50))),
                        (jsch, jsvc, jnp.asarray(_rhs(50)))):
        svc.submit("m0", b)
        with pytest.raises(RuntimeError, match="outside this scheduler"):
            sch.drain()


def test_scheduler_failed_dispatch_keeps_every_ticket_open(monkeypatch):
    svc = _service()
    _program(AsyncSolverEngine(svc), ["m0", "m1"])
    sch = PackedSolverScheduler(svc, max_batch=8)
    tickets = [sch.submit(f"m{i % 2}", torch.from_numpy(_rhs(i)))
               for i in range(5)]
    real = svc.flush_all
    monkeypatch.setattr(svc, "flush_all", lambda *a, **k: (_ for _ in (
        )).throw(RuntimeError("scripted dispatch failure")))
    with pytest.raises(RuntimeError, match="scripted"):
        sch.drain()
    sch.check_consistency()
    assert sch.pending() == 5 and not any(sch.ready(x) for x in tickets)
    monkeypatch.setattr(svc, "flush_all", real)
    sch.drain()
    assert all(sch.result(x).shape == (N,) for x in tickets)


# ------------------------------------------------- engine against JAX -----

def test_engine_answers_match_the_reference_on_jax_programmed_plans():
    mids = ["m0", "m1"]
    jeng = JEngine(JService(JCFG, stages=1), max_batch=4,
                   flush_interval=60.0)
    teng = AsyncSolverEngine(_service(), max_batch=4, flush_interval=60.0)
    for i, mid in enumerate(mids):
        jeng.program(mid, jnp.asarray(_matrix(i)), _jkey(i))
        js = jeng.service.solver(mid)
        teng.install(mid, interop.solver_from_numpy(
            solver_dict(js), TCFG, device="cpu"), _matrix(i),
            np.asarray(_jkey(i)), jeng.matrix_trip(mid))
    out = {}
    for name, eng, wrap in (("jax", jeng, jnp.asarray),
                            ("port", teng, torch.from_numpy)):
        with eng:
            res = []
            for wave in range(3):
                futs = [eng.submit(mids[j % 2], wrap(_rhs(10 * wave + j)),
                                   deadline_s=120.0) for j in range(4)]
                res += [f.result(timeout=120) for f in futs]
        out[name] = res
    for t_res, j_res in zip(out["port"], out["jax"]):
        for field in ("matrix_id", "mode", "health", "reprograms",
                      "deadline_missed", "dispatch_index", "attempts"):
            assert getattr(t_res, field) == getattr(j_res, field), field
        scaled_close(t_res.x, np.asarray(j_res.x), 2e-4)
    assert teng.stats.answered == jeng.stats.answered == 12
    assert teng.stats.dispatches == jeng.stats.dispatches == 3


def _chaos_run(pkg):
    """Four tenants under DispatchException@3 + a stuck-at DeviceFault on
    t0 at 5.  Traffic comes in waves, each flushed by `flush_now` once
    queued, so a wave's buckets dispatch in one worker pass, in bucket
    order (after its recovery t0 programs under another config, so it
    packs in a bucket of its own)."""
    if pkg == "jax":
        ch, svc, key, wrap = (jchaos, JService(JCFG, stages=1), _jkey,
                              jnp.asarray)
        severe = J_SEVERE
        engine_cls = JEngine
    else:
        ch, svc, key, wrap = tchaos, _service(), _tkey, torch.from_numpy
        severe = T_SEVERE
        engine_cls = AsyncSolverEngine
    chaos = ch.ChaosInjector([
        ch.DispatchException(at_dispatch=3),
        ch.DeviceFault(at_dispatch=5, matrix_id="t0", nonideal=severe)])
    mids = ["t0", "t1", "t2", "t3"]
    eng = engine_cls(svc, max_batch=64, flush_interval=60.0, backoff=0.0,
                     retries=2, chaos=chaos)
    for i, mid in enumerate(mids):
        eng.program(mid, wrap(_matrix(i)), key(100 + i))
    results = []
    with eng:
        for wave in range(6):
            futs = [(mid, _rhs(100 * wave + j),)
                    for j, mid in enumerate(mids * 2)]
            futs = [(mid, b, eng.submit(mid, wrap(b), deadline_s=120.0))
                    for mid, b in futs]
            eng.flush_now()
            results += [(mid, b, f.result(timeout=120)) for mid, b, f in futs]
    log = [(i, type(e).__name__) for i, e in chaos.log]
    s = eng.stats
    counts = (s.dispatches, s.retries, s.isolations, s.quarantines,
              s.reprograms, s.replays, s.degraded, s.deadline_misses,
              s.answered)
    meta = [(mid, r.matrix_id, r.mode, r.health, r.reprograms,
             r.dispatch_index, r.attempts) for mid, b, r in results]
    return log, counts, meta, results, eng


def test_chaos_schedule_matches_the_reference_engine():
    jlog, jcounts, jmeta, _, _ = _chaos_run("jax")
    tlog, tcounts, tmeta, results, eng = _chaos_run("port")
    assert tlog == jlog == [(3, "DispatchException"), (5, "DeviceFault")]
    assert tcounts == jcounts
    assert tmeta == jmeta
    assert eng.stats.quarantines == 1 and eng.stats.reprograms == 1
    assert eng.matrix_status("t0") == "healthy"
    for i, mid in enumerate(["t0", "t1", "t2", "t3"]):
        trip = eng.matrix_trip(mid)
        for m, b, r in results:
            if m == mid:
                assert r.mode == "analog" and not r.deadline_missed
                assert _residual(_matrix(i), r.x, b) <= trip
    assert any(r.reprograms == 1 for m, b, r in results if m == "t0")


# --------------------------------------------------- contract 1: futures --

def test_happy_path_program_after_start_and_flush_now():
    svc = _service()
    eng = AsyncSolverEngine(svc, max_batch=64, flush_interval=60.0)
    _program(eng, ["m0"])
    with eng:
        _program(eng, ["m0", "m1"])           # worker hand-off, then hot
        futs = [(mid, b, eng.submit(mid, torch.from_numpy(b)))
                for mid, b in [("m0", _rhs(0)), ("m1", _rhs(1))]]
        assert not any(f.done() for _, _, f in futs)
        eng.flush_now()
        for i, (mid, b, f) in enumerate(futs):
            r = f.result(timeout=60)
            assert r.matrix_id == mid and r.mode == "analog"
            assert r.health == "healthy" and r.attempts == 1
            assert _residual(_matrix(i), r.x, b) < ANALOG_RES
    assert eng.stats.answered == 2 and eng.pending() == 0
    assert set(eng.health()["status"]) == {"m0", "m1"}


def test_submit_validation_is_front_door():
    eng = AsyncSolverEngine(_service(), max_batch=64, flush_interval=60.0)
    _program(eng, ["m0"])
    with pytest.raises(EngineStoppedError):
        eng.submit("m0", _rhs(0))                 # not started yet
    with eng:
        with pytest.raises(KeyError):
            eng.submit("nope", _rhs(0))
        with pytest.raises(ValueError):
            eng.submit("m0", np.zeros((N, 2), np.float32))
        with pytest.raises(ValueError):
            eng.submit("m0", np.arange(N))        # int dtype
        bad = _rhs(0)
        bad[3] = np.nan
        with pytest.raises(ValueError):
            eng.submit("m0", torch.from_numpy(bad))
        assert eng.pending() == 0 and eng.stats.submitted == 0


def test_engine_runs_on_its_services_device():
    svc = _service()
    assert AsyncSolverEngine(svc, device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="differs"):
        AsyncSolverEngine(svc, device="cuda")


@pytest.mark.parametrize("drain", [False, True])
def test_stop_voids_or_drains_leftovers(drain):
    eng = AsyncSolverEngine(_service(), max_batch=64, flush_interval=60.0)
    _program(eng, ["m0"])
    eng.start()
    futs = [eng.submit("m0", _rhs(i)) for i in range(3)]
    eng.stop(drain=drain, timeout=60)
    for f in futs:
        if drain:
            assert f.result(timeout=60).mode == "analog"
        else:
            with pytest.raises(EngineStoppedError):
                f.result(timeout=60)
    with pytest.raises(EngineStoppedError):
        eng.submit("m0", _rhs(9))                 # post-stop admission


def test_submit_after_worker_crash_raises_immediately():
    eng = AsyncSolverEngine(_service(), flush_interval=0.01)
    _program(eng, ["m"])
    eng._bucket_due = lambda q, now: (_ for _ in ()).throw(
        RuntimeError("scripted worker crash"))
    eng.start()
    eng.submit("m", _rhs(0))                      # wakes the worker: crash
    eng._thread.join(timeout=30)
    assert not eng.alive and eng.crashed
    with pytest.raises(EngineStoppedError):
        eng.submit("m", _rhs(1))


def test_thread_stress_concurrent_submitters():
    """Submitters race the worker under a short switch interval: every
    future resolves and no answer is lost or doubled."""
    eng = AsyncSolverEngine(_service(), max_batch=8, flush_interval=0.005,
                            max_pending=256)
    _program(eng, ["s0", "s1"])
    n_threads, per_thread = 6, 10
    results, errors = [], []
    lock = threading.Lock()

    def submitter(t):
        futs = []
        for i in range(per_thread):
            while True:
                try:
                    futs.append(eng.submit("s%d" % ((t + i) % 2),
                                           _rhs(100 * t + i)))
                    break
                except BackpressureError as e:
                    time.sleep(min(e.retry_after_s, 0.05))
        for f in futs:
            try:
                r = f.result(timeout=120)
                with lock:
                    results.append(r)
            except Exception as e:                     # noqa: BLE001
                with lock:
                    errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    eng.start()
    try:
        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=240)
            assert not th.is_alive(), "submitter thread hung"
    finally:
        sys.setswitchinterval(old)
        eng.stop(drain=True, timeout=60)
    assert not errors
    assert len(results) == n_threads * per_thread
    assert eng.stats.answered == eng.stats.submitted == len(results)


# ------------------------------------------ contracts 2-3: SLOs, pressure --

def test_expired_request_is_shed_with_typed_error():
    eng = AsyncSolverEngine(_service(), max_batch=64, flush_interval=60.0)
    _program(eng, ["m0"])
    with eng:
        f = eng.submit("m0", _rhs(0), deadline_s=-1.0)
        with pytest.raises(DeadlineExceededError):
            f.result(timeout=60)
    assert eng.stats.expired == eng.stats.deadline_misses == 1
    assert eng.stats.answered == 0


def test_late_answer_carries_deadline_missed():
    chaos = tchaos.ChaosInjector([tchaos.DispatchLatency(at_dispatch=0,
                                                         seconds=1.5)])
    eng = AsyncSolverEngine(_service(), max_batch=1, flush_interval=0.01,
                            deadline_margin=0.0, chaos=chaos)
    _program(eng, ["m0"])
    with eng:
        r = eng.submit("m0", _rhs(0), deadline_s=1.0).result(timeout=60)
    assert r.deadline_missed and r.mode == "analog"
    assert eng.stats.deadline_misses == 1 and eng.stats.expired == 0


def test_backpressure_rejects_with_retry_after():
    eng = AsyncSolverEngine(_service(), max_batch=64, flush_interval=60.0,
                            max_pending=4)
    _program(eng, ["m0"])
    with eng:
        futs = [eng.submit("m0", _rhs(i)) for i in range(4)]
        with pytest.raises(BackpressureError) as ei:
            eng.submit("m0", _rhs(99))
        assert ei.value.retry_after_s > 0.0
        assert eng.stats.rejected == 1
    assert all(f.result(timeout=60).mode == "analog" for f in futs)


# ------------------------------------------------- contract 4: the ladder --

def test_retry_and_isolation_paths():
    chaos = tchaos.ChaosInjector([tchaos.DispatchException(at_dispatch=0)])
    eng = AsyncSolverEngine(_service(), max_batch=2, flush_interval=60.0,
                            retries=0, chaos=chaos)
    _program(eng, ["m0", "m1"])
    with eng:
        fa = eng.submit("m0", _rhs(0))
        fb = eng.submit("m1", _rhs(1))
        assert fa.result(timeout=60).mode == "analog"
        assert fb.result(timeout=60).mode == "analog"
    assert eng.stats.isolations == 1 and eng.stats.quarantines == 0


def test_persistent_fault_degrades_to_digital_fallback():
    chaos = tchaos.ChaosInjector([tchaos.DeviceFault(
        at_dispatch=0, matrix_id="p0", nonideal=T_SEVERE, persistent=True)])
    eng = AsyncSolverEngine(_service(), max_batch=2, flush_interval=60.0,
                            max_reprograms=2, chaos=chaos)
    _program(eng, ["p0"])
    with eng:
        for rnd in range(2):
            futs = [(b, eng.submit("p0", b))
                    for b in (_rhs(10 * rnd), _rhs(10 * rnd + 1))]
            for b, f in futs:
                r = f.result(timeout=120)
                assert r.mode == "digital" and r.health == "degraded"
                assert r.reprograms == 2
                assert _residual(_matrix(0), r.x, b) < 1e-4
    assert eng.stats.quarantines == 1 and eng.stats.degraded == 1
    assert eng.stats.fallback_rhs == 4
    assert eng.matrix_status("p0") == "degraded"


def test_sixteen_tenants_chaos_acceptance():
    """Stuck-at faults on one of 16 tenants plus a scripted dispatch
    exception: zero deadline misses, the faulted tenant quarantined,
    re-programmed and replayed, every future resolved."""
    mids = ["t%02d" % i for i in range(16)]
    chaos = tchaos.ChaosInjector([
        tchaos.DeviceFault(at_dispatch=1, matrix_id="t00",
                           nonideal=T_SEVERE),
        tchaos.DispatchException(at_dispatch=2)])
    eng = AsyncSolverEngine(_service(), max_batch=16, flush_interval=60.0,
                            max_pending=64, backoff=0.0, chaos=chaos)
    _program(eng, mids)
    with eng:
        for rnd in range(2):
            futs = {mid: eng.submit(mid, _rhs(100 * rnd + i),
                                    deadline_s=120.0)
                    for i, mid in enumerate(mids)}
            results = {mid: f.result(timeout=240) for mid, f in futs.items()}
    assert all(r.mode == "analog" and not r.deadline_missed
               for r in results.values())
    assert all(results[mid].reprograms == 0 for mid in mids[1:])
    assert results["t00"].reprograms == 1
    assert eng.stats.deadline_misses == 0 and eng.stats.quarantines == 1
    assert eng.matrix_status("t00") == "healthy"
    assert [(i, type(e).__name__) for i, e in chaos.log] == [
        (1, "DeviceFault"), (2, "DispatchException")]


# ------------------------------------------- contract 5 and maintenance --

def _drift_run(clock_steps, scrub=True):
    """Scripted traffic on a drifting matrix; returns the chaos firing
    indices and the engine's health export."""
    cfg = TCFG.with_(nonideal=TNi(sigma=0.0, drift_nu=0.05))
    chaos = tchaos.ChaosInjector([tchaos.DispatchException(at_dispatch=2)])
    clock = DeviceClock()
    eng = AsyncSolverEngine(
        SolverService(cfg, stages=2, device="cpu"), clock=clock,
        scrub=scrub, chaos=chaos, flush_interval=60.0, health_floor=0.05,
        maintenance=MaintenanceConfig(scrub_blocks_per_cycle=16,
                                      block_trip=0.02, repair_batch=16))
    with eng:
        eng.program("m", _matrix(0), _tkey(9))
        for step, dt in enumerate(clock_steps):
            clock.advance(dt)
            assert eng.maintenance_quiesce(60.0)
            futs = [eng.submit("m", _rhs(10 * step + j)) for j in range(2)]
            eng.flush_now()
            for f in futs:
                assert f.result(timeout=60).mode == "analog"
        h = eng.health()
    return [idx for idx, _ in chaos.log], h


def test_scrubbing_never_consumes_dispatch_indices():
    fired_heavy, h_heavy = _drift_run([0.6] * 5)
    fired_idle, h_idle = _drift_run([0.0] * 5)
    assert fired_heavy == fired_idle == [2]
    assert h_heavy["scrub_probes"] > 0 and h_heavy["repairs"] > 0
    assert h_idle["scrub_probes"] == 0
    assert h_heavy["quarantines"] == h_idle["quarantines"] == 0
    g = h_heavy["maintenance"]["m"]
    assert g["blocks_repaired"] > 0 and g["scrub_backlog"] == 0.0
