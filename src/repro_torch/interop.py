"""Carry programmed state into the port from plain numpy arrays.

Programming noise cannot be replayed across frameworks, so a plan that was
programmed elsewhere (for example by the JAX package) comes across as its
conductance stacks plus its static schedule.  The format is one dict:

    {
      "n":          int, the system size,
      "g0":         float, the unit conductance the stacks are scaled by,
      "scale":      float or 0-d array, the global normalisation 1/max|A|,
      "schedule":   the flat level program (tuples of str/int, nested
                    tuples for "mvm" rows; see core/blockamc.py),
      "inv_keys":   per INV bucket, (depth, (rows, cols)),
      "mvm_keys":   per MVM bucket, (depth, (rows, cols)),
      "inv_stacks": per INV bucket, (gpos, gneg), each (num, rows, cols),
      "mvm_stacks": per MVM bucket, (gpos, gneg), each (num, rows, cols),
    }

which is `FlatPlan`'s fields with every TileGrid given as its two
conductance arrays.  Lists are accepted where tuples are shown.  A
programmed solver may add its partitioned system and stage count, so that
it can be aged and repaired in the port:

      "stages":     int, the resolved number of partitioning stages,
      "parts":      {"scale": float or 0-d array, "root": target}, where a
                    target is {"a": array} (a leaf) or {"inv1": target,
                    "a2": array, "a3": array, "inv4s": target, "m": int}.

Per-array device ages (`PlanAges`) come across as {"inv": [...], "mvm":
[...]}, one age or (num,) age vector a bucket (`plan_ages_from_numpy`).  A
tile-solver plan (`core/distributed.py`'s `DistPlan`) comes across as

    {
      "stages": int, "g0": float, "scale": float or 0-d array,
      "mvm2":   per level, (gpos, gneg), each (2^level, rt, ct, s, s),
      "mvm3":   the same for the A3 blocks,
      "leaves": (gpos, gneg), each (2^stages, rt, ct, s, s),
    }

Language-model parameters and caches (`models/transformer.py`) come
across as the reference's nested-dict pytree with numpy leaves
(`lm_params_from_numpy`, `lm_cache_from_numpy`); the keys are the same on
both sides.  A training state comes across as its parameters and the
reference's `OptState` (step, m, v) with numpy leaves
(`train_state_from_numpy`), a preconditioner state as the reference's
`PrecondState` (gram, inv, step; `precond_state_from_numpy`).  A
bfloat16 leaf (numpy's `ml_dtypes.bfloat16`, which `torch.from_numpy`
refuses) travels as its 16-bit pattern.

This module sees numpy and torch only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.analog import AnalogConfig, TileGrid
from repro_torch.core.blockamc import (BlockTarget, FlatPlan, LeafTarget,
                                       PartitionedSystem, PlanAges,
                                       ProgrammedSolver)
from repro_torch.core.distributed import DistPlan
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import OptState
from repro_torch.optim.blockamc_precond import PrecondState
from repro_torch.train.train_step import TrainState


def _freeze(x):
    """Nested lists (e.g. from JSON) back to the hashable tuples of the
    static schedule."""
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    return x


def flat_plan_from_numpy(d: dict, device="cuda") -> FlatPlan:
    """Build a FlatPlan on `device` from the dict format above."""
    dev = resolve_device(device)
    scale = torch.tensor(np.asarray(d["scale"]), device=dev)

    def grids(pairs):
        return tuple(
            TileGrid(torch.tensor(np.asarray(gp), device=dev),
                     torch.tensor(np.asarray(gn), device=dev),
                     scale, float(d["g0"]))
            for gp, gn in pairs)

    return FlatPlan(grids(d["inv_stacks"]), grids(d["mvm_stacks"]), scale,
                    _freeze(d["schedule"]), int(d["n"]),
                    _freeze(d["inv_keys"]), _freeze(d["mvm_keys"]))


def parts_from_numpy(d: dict, device="cuda") -> PartitionedSystem:
    """A PartitionedSystem on `device` from the "parts" format above."""
    dev = resolve_device(device)

    def target(t):
        if "a" in t:
            return LeafTarget(torch.tensor(np.asarray(t["a"]), device=dev))
        return BlockTarget(target(t["inv1"]),
                           torch.tensor(np.asarray(t["a2"]), device=dev),
                           torch.tensor(np.asarray(t["a3"]), device=dev),
                           target(t["inv4s"]), int(t["m"]))

    return PartitionedSystem(target(d["root"]),
                             torch.tensor(np.asarray(d["scale"]),
                                          device=dev))


def solver_from_numpy(d: dict, cfg: AnalogConfig,
                      device="cuda") -> ProgrammedSolver:
    """A ProgrammedSolver over a plan carried in the dict format above;
    with "parts" and "stages" it can be aged and repaired."""
    parts = d.get("parts")
    return ProgrammedSolver.from_plan(
        flat_plan_from_numpy(d, device), cfg,
        parts=None if parts is None else parts_from_numpy(parts, device),
        stages=d.get("stages"))


def plan_ages_from_numpy(d: dict, device="cuda") -> PlanAges:
    """PlanAges on `device` from {"inv": [...], "mvm": [...]}."""
    dev = resolve_device(device)

    def ages(xs):
        return tuple(torch.tensor(np.asarray(x), device=dev) for x in xs)
    return PlanAges(ages(d["inv"]), ages(d["mvm"]))


def dist_plan_from_numpy(d: dict, device="cuda") -> DistPlan:
    """Build a tile-solver DistPlan on `device` from the dict format
    above."""
    dev = resolve_device(device)
    scale = torch.tensor(np.asarray(d["scale"]), device=dev)

    def grid(pair):
        gp, gn = pair
        return TileGrid(torch.tensor(np.asarray(gp), device=dev),
                        torch.tensor(np.asarray(gn), device=dev), scale,
                        float(d["g0"]))

    return DistPlan([grid(p) for p in d["mvm2"]],
                    [grid(p) for p in d["mvm3"]], grid(d["leaves"]), scale,
                    int(d["stages"]))


def _tensor(x, dev) -> torch.Tensor:
    """One numpy leaf as a tensor on `dev`, bfloat16 bit for bit."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _tree_from_numpy(tree, dev):
    if isinstance(tree, dict):
        return {key: _tree_from_numpy(val, dev) for key, val in tree.items()}
    return _tensor(tree, dev)


def lm_params_from_numpy(tree: dict, device="cuda") -> dict:
    """The port's LM parameter dict on `device` from the reference's
    parameter pytree with numpy leaves (same keys: `blocks` stacked on a
    leading repeat axis, remainders as `rem{r}`)."""
    return _tree_from_numpy(tree, resolve_device(device))


def lm_cache_from_numpy(tree: dict, device="cuda") -> dict:
    """The port's decode cache on `device` from the reference's cache
    pytree with numpy leaves (same keys and layout)."""
    return _tree_from_numpy(tree, resolve_device(device))


def train_state_from_numpy(params: dict, opt, device="cuda") -> TrainState:
    """The port's TrainState on `device` from the reference's parameter
    pytree and `OptState` (step, m, v), leaves as numpy."""
    dev = resolve_device(device)
    return TrainState(params=_tree_from_numpy(params, dev),
                      opt=OptState(step=_tensor(opt.step, dev),
                                   m=_tree_from_numpy(opt.m, dev),
                                   v=_tree_from_numpy(opt.v, dev)))


def precond_state_from_numpy(state, device="cuda") -> PrecondState:
    """The port's PrecondState on `device` from the reference's
    `PrecondState` (gram, inv, step), leaves as numpy."""
    dev = resolve_device(device)
    return PrecondState(gram=_tree_from_numpy(state.gram, dev),
                        inv=_tree_from_numpy(state.inv, dev),
                        step=_tensor(state.step, dev))
