"""Linear-operator adapters bridging the analog solver into digital Krylov,
as in `repro/hybrid/operators.py`.

Layout contract of the Krylov solvers (`repro_torch.hybrid.krylov`):
right-hand sides ride on leading axes, and an operator is any callable
mapping `(..., n) -> (..., n)` over the trailing axis.

  * `matvec_from_dense(a)` - the digital product `v -> A v` (the exact,
    full-precision residual operator).
  * `AnalogPreconditioner` - one programmed BlockAMC cascade (a
    `FinalizedPlan`: noise, wire model, finite gain and converters folded
    in) applied as `M ~ A^-1`.  It is mixed precision: inputs are cast to
    the plan's compute dtype (the analog substrate), outputs back to the
    caller's dtype (the digital iteration).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import blockamc
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.blockamc import ArenaPlan, FinalizedPlan
from repro_torch.device import resolve_device


def matvec_from_dense(a: torch.Tensor
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """`v -> A v` over the trailing axis of `v` ((..., n) -> (..., n))."""
    def matvec(v: torch.Tensor) -> torch.Tensor:
        return v @ a.T

    return matvec


class AnalogPreconditioner:
    """A programmed analog inverse as a batched digital-domain operator.

    Wraps one `FinalizedPlan` and applies it to `(..., n)` inputs: one
    analog solve per trailing vector, all leading axes batched through the
    executor's multi-RHS path.  `mode` picks the executor: "fused"
    (default) runs the arena executor - on the card, for a uniform plan,
    one arena-kernel launch per application - and "reference" the
    finalized schedule.  The preconditioner is a constant of the Krylov
    solves it serves: nothing differentiates through it.
    """

    def __init__(self, fin: FinalizedPlan,
                 aplan: Optional[ArenaPlan] = None, mode: str = "fused"):
        if mode not in ("reference", "fused"):
            raise ValueError(f"mode must be 'reference' or 'fused', got "
                             f"{mode!r}")
        self.fin = fin
        self.mode = mode
        if aplan is None and mode == "fused":
            aplan = blockamc.compile_arena(fin)
        self.aplan = aplan

    @classmethod
    def program(cls, a, generator: torch.Generator, cfg: AnalogConfig,
                stages: Optional[int] = None, mode: str = "fused",
                device="cuda") -> "AnalogPreconditioner":
        """Full programming flow on `device`: partition, Schur, map and
        noise (`blockamc.program_system`'s draw order), finalize."""
        a = torch.as_tensor(a, device=resolve_device(device))
        fplan = blockamc.compile_plan(blockamc.build_plan(a, generator, cfg,
                                                          stages))
        return cls(blockamc.finalize(fplan, cfg), mode=mode)

    @classmethod
    def from_solver(cls, solver: blockamc.ProgrammedSolver
                    ) -> "AnalogPreconditioner":
        """Share an already-programmed `ProgrammedSolver`'s plans and
        mode."""
        aplan = solver.arena if solver.mode == "fused" else None
        return cls(solver.finalized, aplan=aplan, mode=solver.mode)

    @property
    def n(self) -> int:
        return self.fin.n

    @property
    def cfg(self) -> AnalogConfig:
        return self.fin.cfg

    @property
    def device(self) -> torch.device:
        return self.fin.scale.device

    @property
    def compute_dtype(self) -> torch.dtype:
        """The analog substrate's dtype (set when the plan was built)."""
        return self.fin.scale.dtype

    def _execute(self, cols: torch.Tensor) -> torch.Tensor:
        """One executor call on (n,) / (n, k) columns."""
        if self.mode == "fused" and self.aplan is not None:
            return blockamc.execute_arena(self.aplan, cols)
        return blockamc.execute_finalized(self.fin, cols)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        """Apply M ~ A^-1 to (..., n); returns (..., n) in v's dtype."""
        n = self.fin.n
        if v.ndim == 1:
            return self._execute(v.to(self.compute_dtype)).to(v.dtype)
        lead = tuple(v.shape[:-1])
        cols = v.reshape(-1, n).T.to(self.compute_dtype)      # (n, k)
        out = self._execute(cols)
        return out.T.reshape(lead + (n,)).to(v.dtype)

    apply = __call__
