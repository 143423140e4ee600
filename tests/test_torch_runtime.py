"""The port's program keys and serving runtime against the JAX package:
`repro_torch.keys` (threefry2x32 `PRNGKey` / `fold_in`, bit for bit),
`runtime/fault_tolerance.py`, `runtime/chaos.py` and `runtime/elastic.py`.

The runtime pieces are pure Python: each test drives the reference and
the port through one scripted sequence and requires the same outcome
exactly (backoff schedules, straggler flags, chaos firing logs, mesh
shapes, placements).  Nothing waits on the wall clock.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.nonideal import NonidealConfig as JNi
from repro.runtime import chaos as jchaos
from repro.runtime import elastic as jelastic
from repro.runtime import fault_tolerance as jft
from repro_torch import keys
from repro_torch.core.nonideal import NonidealConfig as TNi
from repro_torch.runtime import chaos as tchaos
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import fault_tolerance as tft


# ---------------------------------------------------------------- keys ----

@pytest.mark.parametrize("seeds", [
    list(range(64)),
    [2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 123456789, 987654321],
    [-1, -7, -(2 ** 31)],
], ids=["small", "wide", "negative"])
def test_prngkey_equals_jax(seeds):
    for s in seeds:
        np.testing.assert_array_equal(keys.PRNGKey(s),
                                      np.asarray(jax.random.PRNGKey(s)))
        assert keys.PRNGKey(s).dtype == np.uint32


def test_fold_in_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    jkey = jax.random.PRNGKey(5)
    for i in range(400):
        data = [i, int(rng.integers(0, 2 ** 32)), 10_000 + i,
                20_000 + i][i % 4]
        got = keys.fold_in(np.asarray(jkey), data)
        np.testing.assert_array_equal(
            got, np.asarray(jax.random.fold_in(jkey, data)))
        # walk the key space: the next key is itself a fold
        jkey = jax.random.fold_in(jkey, int(rng.integers(0, 2 ** 31)))


def test_as_key_takes_jax_keys_and_refuses_other_shapes():
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 9)
    k = keys.as_key(jkey)
    assert k.dtype == np.uint32 and k.shape == (2,)
    np.testing.assert_array_equal(k, np.asarray(jkey))
    for bad in (np.zeros(3, np.uint32), np.zeros((2, 2), np.uint32),
                np.zeros(2, np.float32)):
        with pytest.raises(ValueError):
            keys.as_key(bad)
    with pytest.raises(ValueError):
        keys.PRNGKey(2 ** 64)


def test_generator_is_seeded_from_the_key_words_high_first():
    key = keys.fold_in(keys.PRNGKey(11), 4)
    g1, g2 = keys.generator(key), keys.generator(key.copy())
    assert torch.equal(torch.randn(8, generator=g1),
                       torch.randn(8, generator=g2))
    expect = torch.Generator().manual_seed(
        (int(key[0]) << 32) | int(key[1]))
    assert keys.generator(key).initial_seed() == expect.initial_seed()
    other = keys.generator(keys.fold_in(keys.PRNGKey(11), 5))
    assert not torch.equal(torch.randn(8, generator=keys.generator(key)),
                           torch.randn(8, generator=other))


# ------------------------------------------------------- fault tolerance --

def _retry_trace(ft, fails, retries, backoff, retriable=(RuntimeError,)):
    sleeps, hooks, calls = [], [], [0]

    def fn():
        calls[0] += 1
        if calls[0] <= fails:
            raise (RuntimeError if calls[0] % 2 else ValueError)(
                f"failure {calls[0]}")
        return "ok"

    try:
        out = ft.retry_step(fn, retries=retries, backoff=backoff,
                            retriable=retriable,
                            on_retry=lambda i, e: hooks.append((i, str(e))),
                            sleep=sleeps.append)
    except (RuntimeError, ValueError) as e:
        out = (type(e).__name__, str(e))
    return out, sleeps, hooks, calls[0]


@pytest.mark.parametrize("fails,retries,backoff,retriable", [
    (0, 2, 0.1, (RuntimeError,)),
    (1, 2, 0.1, (RuntimeError,)),
    (5, 3, 0.1, (RuntimeError, ValueError)),
    (2, 3, 0.0, (RuntimeError,)),          # the ValueError is not retried
    (3, 3, 0.05, (RuntimeError, ValueError)),
])
def test_retry_step_matches_reference(fails, retries, backoff, retriable):
    assert _retry_trace(tft, fails, retries, backoff, retriable) == \
        _retry_trace(jft, fails, retries, backoff, retriable)


class _FakeClock:
    """time.monotonic replacement: each step's duration is scripted."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now


def _watchdog_trace(ft, monkeypatch, durations, warmup):
    clock = _FakeClock()
    monkeypatch.setattr(ft, "time", clock)
    flagged = []
    wd = ft.StepWatchdog(factor=3.0, warmup_steps=warmup,
                         on_straggle=lambda t, m: flagged.append((t, m)))
    for dt in durations:
        with wd:
            clock.now += dt
    return flagged, wd.straggles, list(wd.durations)


@pytest.mark.parametrize("warmup", [0, 3, 5])
def test_step_watchdog_matches_reference(monkeypatch, warmup):
    durations = [1.0, 1.0, 5.0, 1.0, 1.0, 1.0, 10.0, 1.0, 2.9, 3.5] + \
        [1.0] * 100 + [50.0]
    port = _watchdog_trace(tft, monkeypatch, durations, warmup)
    ref = _watchdog_trace(jft, monkeypatch, durations, warmup)
    assert port == ref
    assert len(port[2]) == 100              # the rolling window is bounded


# ----------------------------------------------------------------- chaos --

def _events(ch, ni_cls):
    severe = ni_cls(sigma=0.02, p_stuck_off=0.6)
    return [
        ch.DispatchException(at_dispatch=3),
        ch.DispatchLatency(at_dispatch=1, seconds=0.25),
        ch.DeviceFault(at_dispatch=5, matrix_id="b0", nonideal=severe),
        ch.DeviceFault(at_dispatch=2, matrix_id="p0", nonideal=severe,
                       persistent=True),
        ch.ReplicaDeath(at_dispatch=4, replica="r1"),
        ch.ReplicaStall(at_dispatch=2, seconds=0.5, until_dispatch=4,
                        replica="r0"),
        ch.CheckpointCorruption(at_dispatch=6, matrix_id="m", how="values"),
        ch.AcceleratedDrift(at_dispatch=3, matrix_id="b0", factor=5.0),
        ch.HotBlock(at_dispatch=7, matrix_id="b0", block=("inv", 0, 1)),
        ch.DispatchException(at_dispatch=4, replica="r0"),
    ]


def _chaos_trace(ch, ni_cls):
    sleeps, trace = [], []
    inj = ch.ChaosInjector(_events(ch, ni_cls), sleep=sleeps.append)
    recovery = ni_cls(sigma=0.02, compensate_wire=True)
    for idx in range(9):
        for rep in ("r0", "r1", None):
            trace.append(("faults", idx, rep, [
                (e.matrix_id, e.persistent)
                for e in inj.faults_due(idx, replica=rep)]))
            trace.append(("aging", idx, rep, [
                type(e).__name__ for e in inj.aging_due(idx, replica=rep)]))
            trace.append(("corrupt", idx, rep, [
                e.matrix_id for e in inj.corruptions_due(idx, replica=rep)]))
            try:
                inj.on_dispatch(idx, replica=rep)
                trace.append(("dispatch", idx, rep, "ok"))
            except ch.ScriptedDispatchError as e:
                trace.append(("dispatch", idx, rep, "raise", str(e)))
            except ch.ReplicaDeathError as e:
                trace.append(("dispatch", idx, rep, "death", str(e)))
        for mid in ("p0", "b0"):
            trace.append(("reprogram", mid, dataclasses.asdict(
                inj.reprogram_nonideal(mid, recovery))))
    log = [(i, type(e).__name__, getattr(e, "replica", None))
           for i, e in inj.log]
    return trace, sleeps, log, inj.fired


def test_chaos_injector_matches_reference():
    port = _chaos_trace(tchaos, TNi)
    ref = _chaos_trace(jchaos, JNi)
    assert port == ref
    assert ("dispatch", 3, "r0", "raise",
            "chaos: scripted dispatch failure") in port[0]


def test_replica_death_error_is_not_an_exception():
    assert not issubclass(tchaos.ReplicaDeathError, Exception)
    assert issubclass(tchaos.ScriptedDispatchError, RuntimeError)


# --------------------------------------------------------------- elastic --

@pytest.mark.parametrize("candidates,floor", [
    ((16, 8, 4, 2, 1), 1), ((16, 8, 4, 2, 1), 4), ((2, 8, 4, 1), 1),
    ((8, 4), 8)])
def test_elastic_choose_shape_matches_reference(candidates, floor):
    t = telastic.ElasticMesh(model_axis_candidates=candidates,
                             min_model_axis=floor)
    j = jelastic.ElasticMesh(model_axis_candidates=candidates,
                             min_model_axis=floor)
    for n in range(1, 65):
        for divs in ((), (8,), (12, 16), (6,), (3,)):
            assert t.choose_shape(n, divs) == j.choose_shape(n, divs)


def test_assign_replicas_round_robin_and_empty_pool():
    pool = [torch.device("cpu"), torch.device("meta")]
    mesh = telastic.ElasticMesh()
    assert mesh.assign_replicas(5, pool) == [pool[i % 2] for i in range(5)]
    assert mesh.assign_replicas(3, [torch.device("cpu")]) == \
        [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        mesh.assign_replicas(2, [])


def test_assign_replicas_default_pool_is_the_cards():
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = telastic.ElasticMesh()
    if not cards:
        with pytest.raises(ValueError):     # no card: the fleet refuses
            mesh.assign_replicas(3)
    else:
        assert mesh.assign_replicas(3) == [cards[i % len(cards)]
                                           for i in range(3)]
