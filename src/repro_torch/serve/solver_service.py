"""Linear-system serving: program a matrix once, stream right-hand sides, as
in `repro/serve/solver_service.py`.

A registry of `ProgrammedSolver` handles keyed by matrix id, plus a
per-matrix request queue, so right-hand sides that arrive between flushes
are solved in one fused `solve_many` call.

`flush_all` is the cross-matrix form: pending queues are grouped by
`plan_signature`, each bucket's arena plans are packed on a leading
instance axis (cached per signature), ragged queues are zero-padded to one
power-of-two width, and the whole bucket runs as ONE
`execute_arena_packed` call - on the card, one kernel launch.  It commits
in two phases: every bucket is solved before any queue or counter changes,
so a failure leaves the service exactly as it was.

The hybrid paths (`solve_refined`, `solve_fallback`, `flush(refined=True)`)
wait for the port of the Krylov layer and raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.blockamc import (PackedArenaPlan, ProgrammedSolver,
                                       execute_arena_packed,
                                       pack_arena_plans, pad_rhs_pow2,
                                       plan_signature)
from repro_torch.device import resolve_device


def _require_float(name: str, arr) -> None:
    """Front-door dtype gate: programming and dispatch are float pipelines,
    so an int/bool/complex input is rejected with the field name."""
    dtype = arr.dtype
    is_float = dtype.is_floating_point if isinstance(dtype, torch.dtype) \
        else np.issubdtype(dtype, np.floating)
    if not is_float:
        raise ValueError(f"{name} must have a floating dtype, got {dtype} - "
                         f"cast explicitly if the input is intentional")


def _host(x) -> np.ndarray:
    """An owned host copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def _hybrid_slice(what: str):
    return NotImplementedError(
        f"{what} needs the hybrid Krylov layer, which repro_torch does not "
        f"port yet")


@dataclasses.dataclass
class MatrixStats:
    """Per-programmed-matrix serving counters."""
    program_time_s: float        # programming cost, paid once
    solve_calls: int = 0         # fused solve invocations
    rhs_served: int = 0          # individual right-hand sides solved
    refined_calls: int = 0       # hybrid refine calls (none until ported)
    refine_iters: int = 0        # digital Krylov iterations spent


class SolverService:
    """Program-once / solve-many front end over `ProgrammedSolver`.

    `program` pays the programming cost once per matrix; `solve` answers
    immediately; `submit` + `flush` batch queued right-hand sides into one
    solve, and `flush_all` answers every pending tenant in one packed
    dispatch per signature.  All matrices live on `device` ("cuda" unless
    the caller passes "cpu").
    """

    def __init__(self, cfg: AnalogConfig, stages: Optional[int] = None,
                 mode: str = "fused", device="cuda"):
        self.cfg = cfg
        self.stages = stages
        self.mode = mode
        self.device = resolve_device(device)
        self._solvers: Dict[str, ProgrammedSolver] = {}
        self._dense: Dict[str, torch.Tensor] = {}
        self._queues: Dict[str, List[np.ndarray]] = {}
        self._stats: Dict[str, MatrixStats] = {}
        self._sigs: Dict[str, tuple] = {}
        # one cached (id tuple, pack) per signature; program() drops every
        # entry holding the re-programmed id
        self._packs: Dict[tuple, Tuple[Tuple[str, ...],
                                       PackedArenaPlan]] = {}

    def _check_matrix(self, matrix_id: str, a) -> torch.Tensor:
        if self._queues.get(matrix_id):
            raise RuntimeError(
                f"matrix {matrix_id!r} has {len(self._queues[matrix_id])} "
                f"pending rhs; flush before replacing it")
        _require_float("matrix", a)
        a = torch.as_tensor(a, device=self.device)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"matrix must be square 2-D, got "
                             f"{tuple(a.shape)}")
        if not bool(torch.isfinite(a).all()):
            raise ValueError(
                f"matrix {matrix_id!r} contains non-finite entries; "
                f"refusing to program (NaN/Inf would poison every solve "
                f"dispatched against it)")
        return a

    def _register(self, matrix_id, solver, a, cfg, t0) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._solvers[matrix_id] = solver
        self._dense[matrix_id] = a
        self._queues[matrix_id] = []
        self._stats[matrix_id] = MatrixStats(
            program_time_s=time.perf_counter() - t0)
        self._sigs[matrix_id] = plan_signature(a.shape[0], self.stages, cfg)
        self._packs = {sig: (ids, pp) for sig, (ids, pp)
                       in self._packs.items() if matrix_id not in ids}

    def program(self, matrix_id: str, a,
                generator: Optional[torch.Generator] = None,
                cfg: Optional[AnalogConfig] = None) -> ProgrammedSolver:
        """Program matrix `a` under `matrix_id` (replaces any previous one).

        Refuses to replace a matrix with queued right-hand sides, and
        rejects a non-square, non-float or non-finite matrix before any
        state changes.  `generator` defaults to a fresh one seeded 0.
        `cfg` overrides the service config for this matrix; it is part of
        `plan_signature`, so such a tenant packs in its own bucket.  On the
        card the kernel library is loaded here, so the first flush does not
        pay the build.
        """
        a = self._check_matrix(matrix_id, a)
        cfg = cfg if cfg is not None else self.cfg
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        t0 = time.perf_counter()
        solver = ProgrammedSolver.program(a, generator, cfg, self.stages,
                                          mode=self.mode, device=self.device)
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.load("arena_mvm")
        self._register(matrix_id, solver, a, cfg, t0)
        return solver

    def install(self, matrix_id: str, solver: ProgrammedSolver,
                a) -> ProgrammedSolver:
        """Register an already-programmed solver (plans carried from
        elsewhere); same front-door checks and bookkeeping as `program`."""
        a = self._check_matrix(matrix_id, a)
        if a.shape[0] != solver.n:
            raise ValueError(f"solver was programmed for n={solver.n}, "
                             f"matrix is {tuple(a.shape)}")
        if solver.device != self.device:
            raise ValueError(f"solver lives on {solver.device}, the service "
                             f"on {self.device}")
        self._register(matrix_id, solver, a, solver.cfg, time.perf_counter())
        return solver

    def solver(self, matrix_id: str) -> ProgrammedSolver:
        return self._solvers[matrix_id]

    def stats(self, matrix_id: str) -> MatrixStats:
        return self._stats[matrix_id]

    @property
    def matrix_ids(self):
        return tuple(self._solvers)

    def _record(self, matrix_id: str, n_rhs: int) -> None:
        """The one per-tenant bookkeeping path: one fused solve call of
        `n_rhs` right-hand sides."""
        st = self._stats[matrix_id]
        st.solve_calls += 1
        st.rhs_served += n_rhs

    def solve(self, matrix_id: str, b) -> torch.Tensor:
        """Immediate solve of one (n,) rhs or an (n, k) batch."""
        b = torch.as_tensor(b, device=self.device)
        x = self._solvers[matrix_id].solve(b)
        self._record(matrix_id, 1 if b.ndim == 1 else b.shape[1])
        return x

    def solve_refined(self, matrix_id: str, b, **kw):
        raise _hybrid_slice("solve_refined")

    def solve_fallback(self, matrix_id: str, b, **kw):
        raise _hybrid_slice("solve_fallback")

    def submit(self, matrix_id: str, b) -> int:
        """Queue one (n,) rhs for the next flush; returns its queue slot.

        The rhs is copied to the host at admission (a caller reusing one
        buffer cannot mutate a queued request) and rejected if it holds a
        NaN/Inf, before anything is queued.
        """
        n = self._solvers[matrix_id].n
        if tuple(b.shape) != (n,):
            raise ValueError(f"submit takes one ({n},) rhs, got "
                             f"{tuple(b.shape)}")
        _require_float("rhs", b)
        host = _host(b)
        if not np.all(np.isfinite(host)):
            raise ValueError(
                f"rhs for {matrix_id!r} contains non-finite entries; "
                f"rejected at admission (nothing was queued)")
        q = self._queues[matrix_id]
        q.append(host)
        return len(q) - 1

    def pending(self, matrix_id: str) -> int:
        return len(self._queues[matrix_id])

    def discard_pending(self, matrix_id: str) -> int:
        """Drop every queued rhs of one matrix; returns how many."""
        k = len(self._queues[matrix_id])
        self._queues[matrix_id] = []
        return k

    def _solve_queue(self, matrix_id: str) -> torch.Tensor:
        """One tenant's queue as one (n, k) upload and one `solve_many`."""
        bs = torch.as_tensor(np.stack(self._queues[matrix_id], axis=1),
                             device=self.device)
        return self._solvers[matrix_id].solve_many(bs)

    def flush(self, matrix_id: str, *, refined: bool = False
              ) -> torch.Tensor:
        """Solve all queued right-hand sides in one call; returns (n, k),
        column j answering the j-th submit since the last flush ((n, 0)
        for an empty queue)."""
        if refined:
            raise _hybrid_slice("flush(refined=True)")
        q = self._queues[matrix_id]
        solver = self._solvers[matrix_id]
        if not q:
            return torch.zeros((solver.n, 0),
                               dtype=self._dense[matrix_id].dtype,
                               device=self.device)
        xs = self._solve_queue(matrix_id)
        self._record(matrix_id, len(q))
        self._queues[matrix_id] = []    # only drop requests once answered
        return xs

    def _packed_plan(self, sig: tuple,
                     ids: Tuple[str, ...]) -> PackedArenaPlan:
        """The packed arena plan of one tenant bucket, cached per signature
        while the bucket's membership is stable."""
        cached = self._packs.get(sig)
        if cached is not None and cached[0] == ids:
            return cached[1]
        pp = pack_arena_plans([self._solvers[mid].arena for mid in ids])
        self._packs[sig] = (ids, pp)
        return pp

    def flush_all(self, matrix_ids=None) -> Dict[str, np.ndarray]:
        """Answer every pending rhs of every matrix (or of `matrix_ids`)
        with one dispatch per signature bucket.

        Returns {matrix_id: (n, k_id) host array}, column j answering the
        j-th submit since the last flush; ids with empty queues are left
        out.  Single-tenant buckets and mode="reference" services take the
        per-matrix `flush` body.
        """
        if matrix_ids is None:
            ids = tuple(self._queues)
        else:
            ids = tuple(dict.fromkeys(matrix_ids))   # dedupe, keep order
            for mid in ids:
                self._queues[mid]   # unknown ids raise KeyError, like solve
        pending = [mid for mid in ids if self._queues.get(mid)]
        buckets: Dict[tuple, List[str]] = {}
        for mid in pending:
            buckets.setdefault(self._sigs[mid], []).append(mid)
        # Phase 1 - solve every bucket without touching service state.
        staged = []                     # (bucket ids, per-tenant ks, xs)
        for sig, bucket in buckets.items():
            if len(bucket) == 1 or self.mode != "fused":
                for mid in bucket:
                    xs = self._solve_queue(mid).cpu().numpy()
                    staged.append(([mid], [len(self._queues[mid])],
                                   xs[None]))
                continue
            ks = [len(self._queues[mid]) for mid in bucket]
            n = self._solvers[bucket[0]].n
            tenant_stacks = [np.stack(self._queues[mid], axis=1)
                             for mid in bucket]
            stacked = np.zeros(
                (len(bucket), n, max(ks)),
                dtype=np.result_type(*(s.dtype for s in tenant_stacks)))
            for i, cols in enumerate(tenant_stacks):
                stacked[i, :, :ks[i]] = cols
            bs, _ = pad_rhs_pow2(torch.as_tensor(stacked,
                                                 device=self.device))
            pp = self._packed_plan(sig, tuple(bucket))
            staged.append((bucket, ks,
                           execute_arena_packed(pp, bs).cpu().numpy()))
        # Phase 2 - every dispatch succeeded: commit queues and counters.
        results: Dict[str, np.ndarray] = {}
        for bucket, ks, xs_host in staged:
            for i, (mid, k) in enumerate(zip(bucket, ks)):
                results[mid] = xs_host[i, :, :k].copy()
                self._record(mid, k)
                self._queues[mid] = []
        return results
