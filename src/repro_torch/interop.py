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
conductance arrays.  Lists are accepted where tuples are shown.  This
module sees numpy and torch only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.analog import AnalogConfig, TileGrid
from repro_torch.core.blockamc import FlatPlan, ProgrammedSolver
from repro_torch.device import resolve_device


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


def solver_from_numpy(d: dict, cfg: AnalogConfig,
                      device="cuda") -> ProgrammedSolver:
    """A ProgrammedSolver over a plan carried in the dict format above."""
    return ProgrammedSolver.from_plan(flat_plan_from_numpy(d, device), cfg)
