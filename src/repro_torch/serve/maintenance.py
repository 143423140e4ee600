"""Drift-aware self-healing: device clock, scrub trends, repair scheduling,
as in `repro/serve/maintenance.py`.

Retention drift (power-law G(t) = G * t^-nu, `core/nonideal.py`) happens
to a programmed plan while it serves.  This module keeps the state that
lets the serving stack live with it:

* A `DeviceClock`, the simulated device time shared by everything that
  models time, and per-array `programmed_at` timestamps in
  `MatrixMaintenance`.  Aging never touches the stored conductances -
  drift is a readout effect - so a caller re-finalizes the retained flat
  plan at the current `plan_ages` (`ProgrammedSolver.aged`) and swaps it
  in (`SolverService.refresh`).
* Scrubbing: `scrub` probes a few arrays round-robin with one cheap
  per-array MVM (`a_eff(drift_t=age) @ v` against a baseline taken at
  programming time), never a full solve.  Each array's relative
  deviation feeds a `BlockTrend` (EWMA slope and a one-sided CUSUM) that
  predicts the time to trip.
* Repair scheduling: an array over `block_trip`, or predicted to cross it
  within `repair_lead`, joins `pending`; the caller re-programs just those
  (`ProgrammedSolver.repaired`), refreshes the service and reports them
  with `note_repaired`.

A block's deviation under pure drift is |1 - age^-nu|, so `block_trip`
bounds the per-array operator error tolerated before a repair.  The trend
arithmetic is plain floats; the probes run on the plan's device.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import blockamc

BlockRef = Tuple[str, int, int]          # ("inv"|"mvm", bucket, index)


class DeviceClock:
    """Advanceable simulated device time (seconds; t=0 at construction).

    Thread-safe; subscribers are notified outside the lock on every
    `advance`.
    """

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)
        self._lock = threading.Lock()
        self._subs: List[Callable[[], None]] = []

    def now(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> float:
        """Move time forward by `dt` seconds; returns the new time."""
        if dt < 0:
            raise ValueError(f"device time cannot run backwards (dt={dt})")
        with self._lock:
            self._t += float(dt)
            t = self._t
            subs = list(self._subs)
        for cb in subs:
            cb()
        return t

    def subscribe(self, cb: Callable[[], None]) -> None:
        with self._lock:
            if cb not in self._subs:
                self._subs.append(cb)

    def unsubscribe(self, cb: Callable[[], None]) -> None:
        with self._lock:
            if cb in self._subs:
                self._subs.remove(cb)


@dataclasses.dataclass(frozen=True)
class MaintenanceConfig:
    """Scrub/repair policy knobs.

    `scrub_blocks_per_cycle`: probes per maintenance cycle.
    `block_trip`: relative per-array probe deviation that marks an array
    degraded (repair now).
    `repair_lead`: repair when the trend predicts `block_trip` within this
    many clock seconds (0 = repair only on trip).
    `repair_batch`: most arrays repaired per cycle.
    `ewma_alpha` / `min_probes`: trend smoothing and the evidence floor
    before extrapolation is trusted.
    """
    scrub_blocks_per_cycle: int = 8
    block_trip: float = 0.05
    repair_lead: float = 0.0
    repair_batch: int = 8
    ewma_alpha: float = 0.5
    min_probes: int = 2


class BlockTrend:
    """EWMA slope + one-sided CUSUM of one array's probe deviation.

    `slope` is an EWMA of d(dev)/dt in clock units; `cusum` accumulates
    positive deviation increments.  Linear extrapolation of the concave
    power-law deviation predicts the trip early, the safe direction.
    """

    __slots__ = ("alpha", "t", "dev", "slope", "probes", "cusum")

    def __init__(self, alpha: float = 0.5):
        self.alpha = float(alpha)
        self.t: Optional[float] = None
        self.dev: Optional[float] = None
        self.slope: Optional[float] = None
        self.probes = 0
        self.cusum = 0.0

    def observe(self, t: float, dev: float) -> None:
        if self.t is not None and t > self.t:
            inst = (dev - self.dev) / (t - self.t)
            self.slope = inst if self.slope is None else (
                self.alpha * inst + (1.0 - self.alpha) * self.slope)
            self.cusum = max(0.0, self.cusum + (dev - self.dev))
        self.t, self.dev = float(t), float(dev)
        self.probes += 1

    def ready(self, min_probes: int) -> bool:
        return self.probes >= min_probes and self.slope is not None

    def time_to_trip(self, trip: float) -> float:
        """Predicted clock seconds until `dev` crosses `trip` (inf if the
        trend is flat or improving; 0 if already over)."""
        if self.dev is None:
            return float("inf")
        if self.dev >= trip:
            return 0.0
        if self.slope is None or self.slope <= 0.0:
            return float("inf")
        return (trip - self.dev) / self.slope


class MatrixMaintenance:
    """Per-matrix maintenance state: ages, probe baselines, trends.

    Probing needs no digital targets: each array's baseline response
    (fresh `a_eff @ v` at age 1) is taken at program/repair time, and its
    deviation is measured against it.
    """

    def __init__(self, solver: blockamc.ProgrammedSolver,
                 mcfg: MaintenanceConfig, now: float):
        if not solver.repairable:
            raise ValueError("maintenance needs a repairable solver "
                             "(retained flat plan + partitioned system)")
        self.mcfg = mcfg
        self.refs: Tuple[BlockRef, ...] = tuple(
            r.ref for r in solver.block_map())
        self.programmed_at: Dict[BlockRef, float] = {
            ref: now for ref in self.refs}
        self.probed_at: Dict[BlockRef, float] = {ref: now
                                                 for ref in self.refs}
        self.trends: Dict[BlockRef, BlockTrend] = {
            ref: BlockTrend(mcfg.ewma_alpha) for ref in self.refs}
        self.age_scale = 1.0
        self.block_scale: Dict[BlockRef, float] = {}
        self.pending: set = set()                  # repairs scheduled
        self.synced_at = now                       # plan ages last baked at
        self.repair_rounds = 0
        self.blocks_repaired = 0
        self._cursor = 0
        self._probe_v: Dict[BlockRef, np.ndarray] = {}
        self._baseline: Dict[BlockRef, np.ndarray] = {}
        for ref in self.refs:
            self._calibrate(solver.flat, solver.cfg, ref)

    # -- block access ----------------------------------------------------

    @staticmethod
    def _pair(fplan: blockamc.FlatPlan, ref: BlockRef):
        kind, b, i = ref
        grid = (fplan.inv_stacks if kind == "inv" else fplan.mvm_stacks)[b]
        return grid.tile(i)

    def _response(self, fplan, cfg, ref: BlockRef, age: float) -> np.ndarray:
        """One array's readout at `age` applied to its probe vector."""
        a = self._pair(fplan, ref).a_eff(cfg, drift_t=age)
        v = torch.as_tensor(self._probe_v[ref], dtype=a.dtype,
                            device=a.device)
        return (a @ v).cpu().numpy()

    def _calibrate(self, fplan, cfg, ref: BlockRef) -> None:
        c = self._pair(fplan, ref).shape[1]
        v = np.linspace(1.0, 2.0, c, dtype=np.float64).astype(np.float32)
        v /= np.linalg.norm(v)
        self._probe_v[ref] = v
        self._baseline[ref] = self._response(fplan, cfg, ref, 1.0)

    # -- aging -----------------------------------------------------------

    def age(self, ref: BlockRef, now: float) -> float:
        dt = max(0.0, now - self.programmed_at[ref])
        return 1.0 + dt * self.age_scale * self.block_scale.get(ref, 1.0)

    def plan_ages(self, fplan: blockamc.FlatPlan,
                  now: float) -> blockamc.PlanAges:
        """Every array's age at `now`, one float32 vector a bucket on the
        plan's device."""
        dev = fplan.scale.device

        def per_bucket(kind, stacks):
            return tuple(
                torch.tensor([self.age((kind, b, i), now)
                              for i in range(g.shape[-3])],
                             dtype=torch.float32, device=dev)
                for b, g in enumerate(stacks))
        return blockamc.PlanAges(per_bucket("inv", fplan.inv_stacks),
                                 per_bucket("mvm", fplan.mvm_stacks))

    # -- scrubbing -------------------------------------------------------

    def backlog(self, now: float) -> int:
        """Arrays not yet probed at the current clock time."""
        return sum(1 for ref in self.refs if self.probed_at[ref] < now)

    def probe(self, fplan, cfg, ref: BlockRef, now: float) -> float:
        """One cheap per-array canary MVM; relative deviation against the
        baseline."""
        out = self._response(fplan, cfg, ref, float(self.age(ref, now)))
        base = self._baseline[ref]
        return float(np.linalg.norm(out - base)
                     / (np.linalg.norm(base) + 1e-12))

    def scrub(self, fplan, cfg, now: float, budget: int) -> int:
        """Probe up to `budget` stale arrays round-robin; schedule repairs
        for arrays over `block_trip` or trending into it within
        `repair_lead`.  Returns the number of probes made."""
        done = 0
        for _ in range(len(self.refs)):
            if done >= budget:
                break
            ref = self.refs[self._cursor]
            self._cursor = (self._cursor + 1) % len(self.refs)
            if self.probed_at[ref] >= now:
                continue
            dev = self.probe(fplan, cfg, ref, now)
            tr = self.trends[ref]
            tr.observe(now, dev)
            self.probed_at[ref] = now
            done += 1
            if dev >= self.mcfg.block_trip or (
                    tr.ready(self.mcfg.min_probes)
                    and tr.time_to_trip(self.mcfg.block_trip)
                    <= self.mcfg.repair_lead):
                self.pending.add(ref)
        return done

    # -- repair bookkeeping ----------------------------------------------

    def note_repaired(self, refs, fplan, cfg, now: float) -> None:
        """Reset the age, trend and baseline of just-repaired arrays."""
        for ref in refs:
            self.programmed_at[ref] = now
            self.probed_at[ref] = now
            self.trends[ref] = BlockTrend(self.mcfg.ewma_alpha)
            self.pending.discard(ref)
            self._calibrate(fplan, cfg, ref)
        self.blocks_repaired += len(refs)

    # -- gauges ----------------------------------------------------------

    def gauges(self, now: float) -> Dict[str, float]:
        """Report-only drift gauges."""
        devs = [t.dev for t in self.trends.values() if t.dev is not None]
        slopes = [t.slope for t in self.trends.values()
                  if t.slope is not None]
        ttts = [t.time_to_trip(self.mcfg.block_trip)
                for t in self.trends.values() if t.dev is not None]
        return {
            "age": max(self.age(ref, now) for ref in self.refs),
            "worst_dev": max(devs) if devs else 0.0,
            "trend_slope": max(slopes) if slopes else 0.0,
            "time_to_trip": min(ttts) if ttts else float("inf"),
            "scrub_backlog": float(self.backlog(now)),
            "pending_repairs": float(len(self.pending)),
            "blocks_repaired": float(self.blocks_repaired),
        }
