"""Fault-tolerance runtime pieces: step watchdog + bounded retry, as in
`repro/runtime/fault_tolerance.py`.

At thousand-node scale the failure modes are (a) a chip/host dying (surfaces
as an exception from the collective), (b) a straggler/hang (surfaces as a
step that never completes).  The watchdog covers (b) by timing each step
against a rolling deadline; the retry wrapper covers (a) by re-raising after
bounded, logged retries so the outer launcher can restore from the last
checkpoint - the standard checkpoint/restart contract.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional, TypeVar

log = logging.getLogger("repro_torch.runtime")

T = TypeVar("T")


class StepWatchdog:
    """Flags steps exceeding `factor` x rolling-median duration (stragglers).

    Use as a context manager around each training step.  `on_straggle` is
    called with (step_time, median) - production would page / trigger
    preemptive re-scheduling; tests inject a callback.
    """

    def __init__(self, factor: float = 3.0, warmup_steps: int = 5,
                 hard_timeout: Optional[float] = None,
                 on_straggle: Optional[Callable[[float, float], None]] = None):
        self.factor = factor
        self.warmup_steps = warmup_steps
        self.hard_timeout = hard_timeout
        self.on_straggle = on_straggle or (
            lambda t, m: log.warning("straggler: step %.3fs vs median %.3fs", t, m))
        self.durations: list = []
        self._timer: Optional[threading.Timer] = None
        self.straggles = 0

    def _median(self) -> float:
        d = sorted(self.durations)
        return d[len(d) // 2]

    def __enter__(self):
        self._t0 = time.monotonic()
        if self.hard_timeout is not None:
            self._timer = threading.Timer(
                self.hard_timeout,
                lambda: self.on_straggle(self.hard_timeout, float("inf")))
            self._timer.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._timer is not None:
            self._timer.cancel()
        dt = time.monotonic() - self._t0
        # the window must be non-empty before a median exists, whatever
        # warmup the caller asked for (warmup_steps=0 is a valid config:
        # hard_timeout-only watchdogs in the serving engine use it)
        if self.durations and len(self.durations) >= self.warmup_steps:
            med = self._median()
            if dt > self.factor * med:
                self.straggles += 1
                self.on_straggle(dt, med)
        self.durations.append(dt)
        if len(self.durations) > 100:
            self.durations.pop(0)
        return False


def retry_step(fn: Callable[[], T], retries: int = 2,
               backoff: float = 0.0,
               retriable=(RuntimeError,),
               on_retry: Optional[Callable[[int, BaseException], None]] = None,
               sleep: Callable[[float], None] = time.sleep) -> T:
    """Run fn with bounded retries on transient runtime errors.

    `backoff` is the base of an exponential schedule: attempt k sleeps
    `backoff * 2**k` before retrying (0 disables sleeping).  Non-retriable
    exceptions propagate immediately; the last retriable failure re-raises
    unchanged after `retries` retries so the caller's failover ladder (the
    async engine quarantines / re-programs) sees the original error.
    `on_retry(attempt_index, exc)` is called before each backoff sleep -
    serving engines hang their retry counters there; `sleep` is injectable
    so tests can pin the exact backoff schedule without waiting it out.
    """
    for attempt in range(retries + 1):
        try:
            return fn()
        except retriable as e:
            if attempt == retries:
                raise
            log.warning("step failed (%s); retry %d/%d", e, attempt + 1, retries)
            if on_retry is not None:
                on_retry(attempt, e)
            if backoff:
                sleep(backoff * (2 ** attempt))
    raise AssertionError("unreachable")
