"""BlockAMC-preconditioned optimizer: the paper's solver inside training,
as `repro/optim/blockamc_precond.py`.

The paper positions AMC as a linear-system accelerator; its natural home in
an LM training stack is the second-order preconditioner (cf. RePAST, the
paper's ref [30]).  A Kronecker-factored Gram matrix G = E[g^T g] over
each eligible 2-D parameter's second dimension is kept, and gradients are
preconditioned Shampoo-style with the inverse root

    p = g (G + lambda I)^-1/2

computed by the Denman-Beavers iteration

    Y_0 = A, Z_0 = I;  Y_{k+1} = (Y_k + Z_k^-1)/2, Z_{k+1} = (Z_k + Y_k^-1)/2
    Y_k -> A^1/2, Z_k -> A^-1/2

whose core primitive is matrix inversion.  Each step's two inverses run
through `core.distributed.block_inv`, the digital BlockAMC recursion, or
(`use_analog=True`) through the analog simulator: the matrix is
programmed with `ProgrammedSolver.program`, and one batched
`hybrid.pcg_fixed` over all identity columns, seeded by the programmed
cascade (`AnalogPreconditioner`, the arena kernel on the card: one
launch a program), spends exactly `refine_iters` digital iterations.

Keys follow the reference's chain (`keys.PRNGKey`, `keys.fold_in`,
bit-identical threefry); each program draws its noise from a fresh
`keys.generator(key)`, as the serving stack's programming does.  Every
inverse runs on the device of the Gram matrix.  A parameter is eligible
where it is 2-D with a second dimension of at most `max_dim`; the others
hold a (0,) placeholder, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import keys
from repro_torch.core import blockamc
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.distributed import block_inv
from repro_torch.hybrid import (AnalogPreconditioner, matvec_from_dense,
                                pcg_fixed)
from repro_torch.numerics import over
from repro_torch.tree import tree_leaves, tree_map


class PrecondState(NamedTuple):
    gram: Any        # per-leaf (d, d) or a (0,) placeholder
    inv: Any         # cached inverse factors
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BlockAMCPrecond:
    beta: float = 0.95
    damping: float = 1e-3
    update_every: int = 20
    leaf_size: int = 64         # BlockAMC array size for the recursion
    max_dim: int = 2048         # precondition only if the dim is <= this
    use_analog: bool = False    # route inverses through the simulator
    analog_cfg: AnalogConfig = AnalogConfig(array_size=64)
    refine_iters: int = 4       # digital refinement after an analog seed
    analog_precond: bool = False  # also precondition CG with the programmed
    # arrays: faster under near-ideal programming, but a noisy analog
    # inverse can leave the SPD cone and make the fixed refine_iters budget
    # worse than seed-only CG (TESTING.md regime map) - so opt-in.
    db_iters: int = 14          # Denman-Beavers iterations for the inv-root

    def _eligible(self, p) -> bool:
        return p.ndim == 2 and p.shape[1] <= self.max_dim

    def init(self, params) -> PrecondState:
        def filled(p, fn):
            if not self._eligible(p):
                return torch.zeros((0,), device=p.device)
            return fn(torch.eye(p.shape[1], dtype=torch.float32,
                                device=p.device))

        step_dev = next(tree_leaves(params)).device
        return PrecondState(
            gram=tree_map(lambda p: filled(p, lambda e: e * self.damping),
                          params),
            inv=tree_map(lambda p: filled(p, lambda e: over(e, self.damping)),
                         params),
            step=torch.zeros((), dtype=torch.int32, device=step_dev))

    def update_stats(self, grads, state: PrecondState) -> PrecondState:
        def one(g, gr):
            if gr.numel() == 0:
                return gr
            g32 = g.to(torch.float32)
            new = over(g32.T @ g32, g.shape[0])
            return self.beta * gr + (1 - self.beta) * new

        gram = tree_map(one, grads, state.gram)
        return state._replace(gram=gram, step=state.step + 1)

    def _inv(self, a: torch.Tensor, key) -> torch.Tensor:
        """One matrix inverse - the BlockAMC primitive (digital or analog)."""
        if not self.use_analog:
            return block_inv(a, self.leaf_size)
        # program once, then one batched CG over all n identity columns
        # (leading-axis multi-rhs) seeded by the programmed cascade;
        # pcg_fixed spends exactly refine_iters iterations per column
        solver = blockamc.ProgrammedSolver.program(
            a, keys.generator(key), self.analog_cfg, device=a.device)
        precond = AnalogPreconditioner.from_solver(solver)
        eye = torch.eye(a.shape[0], dtype=torch.float32, device=a.device)
        res = pcg_fixed(matvec_from_dense(a), eye,
                        precond=precond if self.analog_precond else None,
                        x0=precond(eye), iters=self.refine_iters)
        return res.x.T    # row i solves A x = e_i -> column i of A^-1

    def _invert(self, gram: torch.Tensor, key) -> torch.Tensor:
        """(G + lambda I)^-1/2 via Denman-Beavers (inverse-only iteration)."""
        d = gram.shape[0]
        eye = torch.eye(d, dtype=torch.float32, device=gram.device)
        a = gram + self.damping * eye
        # scale to unit spectral-ish norm for DB convergence
        c = over(torch.trace(a), d)
        y = a / c
        z = eye
        for i in range(self.db_iters):
            ki = keys.fold_in(key, i)
            y_inv = self._inv(y, ki)
            z_inv = self._inv(z, keys.fold_in(ki, 1))
            y, z = 0.5 * (y + z_inv), 0.5 * (z + y_inv)
        return z / torch.sqrt(c)     # -> (A/c)^-1/2 / sqrt(c) = A^-1/2

    def refresh_inverses(self, state: PrecondState,
                         key=None) -> PrecondState:
        key = keys.PRNGKey(0) if key is None else keys.as_key(key)

        def one(gr, old_inv):
            if gr.numel() == 0:
                return old_inv
            return self._invert(gr, key)

        return state._replace(inv=tree_map(one, state.gram, state.inv))

    def precondition(self, grads, state: PrecondState):
        def one(g, inv):
            if inv.numel() == 0:
                return g
            return (g.to(torch.float32) @ inv).to(g.dtype)

        return tree_map(one, grads, state.inv)
