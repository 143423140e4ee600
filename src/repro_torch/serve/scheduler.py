"""Continuous-batching flush policy for the multi-tenant solver service,
as in `repro/serve/scheduler.py`.

`PackedSolverScheduler` applies the keep-every-slot-busy discipline of
production serving to `serve.SolverService`'s packed flush: admit
streaming (matrix_id, rhs) requests, fire a signature bucket through the
packed `flush_all` dispatch the moment it fills, drain stragglers on
demand.  (The LM continuous-batching engine lives in
`repro_torch.models.lm_scheduler`; `serve/` is the solver serving
namespace.)
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class PackedSolverScheduler:
    """Continuous-batching flush policy over a `serve.SolverService`.

    Requests stream in as (matrix_id, rhs) pairs; each `submit` returns a
    ticket.  The moment the submitting matrix's *signature bucket* (all
    tenants sharing its `plan_signature`) accumulates `max_batch` pending
    right-hand sides, that bucket alone flushes through the service's
    packed `flush_all` - one fused dispatch over (tenants x rhs) - while
    other buckets keep filling, exactly the keep-every-slot-busy
    discipline of `ContinuousBatchingEngine` applied to solver tenants.
    `drain()` flushes everything still queued; `result(ticket)` retrieves
    (and drops) a delivered solution, `ready(ticket)` polls.

    The scheduler must be the service's only queue writer: tickets map to
    answer columns by per-tenant submission order, so right-hand sides
    submitted or flushed *directly* on the service while a scheduler is
    attached would shift that mapping.  `_deliver` raises rather than
    mis-assign when it detects more answers than open tickets.  Admission
    is O(1): a per-signature running counter decides the flush trigger,
    and the O(num_tenants) bucket scan happens only when a flush fires.
    """

    def __init__(self, service, max_batch: int = 8):
        self.service = service
        self.max_batch = max_batch
        self._results: Dict[tuple, np.ndarray] = {}
        self._submitted: Dict[str, int] = {}    # tickets handed out per tenant
        self._delivered: Dict[str, int] = {}    # tickets answered per tenant
        self._sig_pending: Dict[tuple, int] = {}   # open rhs per signature

    def submit(self, matrix_id: str, b) -> tuple:
        """Queue one (n,) rhs (a tensor or an array); returns its ticket.
        May trigger a bucket flush (in which case this and every
        bucket-mate's pending rhs resolve)."""
        self.service.submit(matrix_id, b)
        seq = self._submitted.get(matrix_id, 0)
        self._submitted[matrix_id] = seq + 1
        sig = self.service.signature(matrix_id)
        count = self._sig_pending.get(sig, 0) + 1
        # counter is written before the flush attempt: flush_all is
        # all-or-nothing, so a failed dispatch leaves the queues (and
        # this count) valid for a retry on the next submit or drain.
        # Once flush_all returns, the queues ARE consumed, so the counter
        # resets before delivery whatever _deliver decides.
        self._sig_pending[sig] = count
        if count >= self.max_batch:
            answers = self.service.flush_all(
                [mid for mid in self.service.matrix_ids
                 if self.service.signature(mid) == sig])
            self._sig_pending[sig] = 0
            self._deliver(answers)
        return (matrix_id, seq)

    def pending(self) -> int:
        """Right-hand sides admitted but not yet flushed, over all tenants."""
        return sum(self._sig_pending.values())

    def drain(self) -> None:
        """Flush every remaining queue (end of a serving window).

        Exception safety (the scheduler-layer extension of `flush_all`'s
        all-or-nothing staging): `flush_all` commits no queue/counter state
        until every bucket's dispatch succeeded, so a dispatch that raises
        mid-drain propagates with the service queues, the per-signature
        counters and every open ticket exactly as they were - `drain()`
        (or the next triggering submit) can simply be retried.  Counters
        are cleared only after `flush_all` returns, i.e. only once the
        queues really were consumed."""
        answers = self.service.flush_all()
        self._sig_pending.clear()   # queues consumed whatever happens next
        self._deliver(answers)

    def check_consistency(self) -> None:
        """Assert scheduler counters agree with the service's queues.

        The invariant the exception-safety contract preserves across
        failed dispatches: for every tenant, open tickets (handed out minus
        answered) equal the service's pending queue depth, and the
        per-signature counters are exactly the bucket sums of those
        depths.  Cheap (host-side dict walks); failure-injection tests
        call it after every induced dispatch error, and a production
        caller may call it at flush boundaries."""
        per_sig: Dict[tuple, int] = {}
        for mid in self.service.matrix_ids:
            depth = self.service.pending(mid)
            open_tickets = (self._submitted.get(mid, 0)
                            - self._delivered.get(mid, 0))
            if depth != open_tickets:
                raise AssertionError(
                    f"tenant {mid!r}: {depth} queued rhs vs "
                    f"{open_tickets} open tickets")
            if depth:
                sig = self.service.signature(mid)
                per_sig[sig] = per_sig.get(sig, 0) + depth
        counters = {s: c for s, c in self._sig_pending.items() if c}
        if per_sig != counters:
            raise AssertionError(
                f"per-signature counters {counters} disagree with "
                f"service queues {per_sig}")

    def ready(self, ticket: tuple) -> bool:
        return ticket in self._results

    def result(self, ticket: tuple) -> np.ndarray:
        """The (n,) host-resident solution for `ticket` (one-shot: the
        entry is dropped)."""
        return self._results.pop(ticket)

    def _deliver(self, answers: Dict[str, np.ndarray]) -> None:
        # deliver every well-formed tenant first, then raise on any
        # contract violation - one externally-written queue must not
        # discard innocent tenants' already-computed answers.  The bad
        # tenant's open tickets are marked consumed (its answers cannot
        # be attributed), so a caller that catches the error and keeps
        # going can never have a *later* flush land on its stale tickets.
        bad = None
        for mid, xs in answers.items():
            base = self._delivered.get(mid, 0)
            open_tickets = self._submitted.get(mid, 0) - base
            if xs.shape[1] > open_tickets:
                bad = (mid, xs.shape[1], open_tickets)
                self._delivered[mid] = self._submitted.get(mid, 0)
                continue
            for j in range(xs.shape[1]):
                self._results[(mid, base + j)] = xs[:, j]
            self._delivered[mid] = base + xs.shape[1]
        if bad is not None:
            raise RuntimeError(
                f"flush answered {bad[1]} rhs for {bad[0]!r} but only "
                f"{bad[2]} tickets are open - the service's queue was "
                f"written outside this scheduler; the tenant's open "
                f"tickets are void")
