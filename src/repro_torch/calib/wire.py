"""Wire-resistance calibration by gradient descent through the solver, as
in `repro/calib/wire.py`.

The hot-path wire model (`core.nonideal.effective_conductance`) is first
order in r*G and linear in r; the exact physics is the nodal MNA readout
(`repro_torch.physics.nodal`).  With the arena cascade's backward
(`core.blockamc._Cascade`) the chain

    r_hat -> finalize(fplan, cfg, r_wire=r_hat) -> compile_arena
          -> execute_arena -> x_model(r_hat)

is differentiable end to end by autograd, without re-programming, so
calibration is plain optimisation: descend the mismatch between model
outputs and observed outputs until r_hat explains the measurements.  On
the card the cascade's forward runs the arena kernel and the nodal
oracle's sweeps the block-Thomas kernel.

The first-order model is within ~0.2% of the nodal one at n=8, r=1 ohm
and ~6% at n=64, so recovering a planted resistance to 5% holds at small
arrays.  Programming noise is not calibrated here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import blockamc
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.nonideal import NonidealConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class WireCalibration:
    """Result of a wire-resistance fit."""
    r_hat: float                 # fitted wire segment resistance [ohm]
    loss: float                  # final relative-MSE mismatch
    history: Tuple[float, ...]   # loss at each step
    r_history: Tuple[float, ...]  # r_hat after each step
    steps: int

    def rel_err(self, r_true: float) -> float:
        """Relative recovery error against a known planted resistance."""
        return abs(self.r_hat - r_true) / abs(r_true)


def _model_outputs(fplan, cfg: AnalogConfig, b: torch.Tensor,
                   r_hat: torch.Tensor) -> torch.Tensor:
    """Differentiable solver outputs under the first-order model at r_hat."""
    fin = blockamc.finalize(fplan, cfg, r_wire=r_hat)
    return blockamc.execute_arena(blockamc.compile_arena(fin), b)


def calibrate_wire_to(fplan, cfg: AnalogConfig, b: torch.Tensor,
                      x_obs: torch.Tensor, *, r_init: float = 0.25,
                      lr: float = 0.05, steps: int = 150,
                      on_step: Optional[Callable[[int, float, float],
                                                 None]] = None
                      ) -> WireCalibration:
    """Fit r_hat so the first-order solver output matches observations.

    `fplan` is the system's FlatPlan (clean programming: all mismatch is
    put down to wire resistance), `cfg` the finalization config (its
    static r_wire is overridden), `b` the (n, k) probe right-hand sides,
    `x_obs` their observed (n, k) solutions.  The descent is the
    reference's scalar Adam (b1 0.9, b2 0.999, eps 1e-8) on log r, from
    `r_init` with rate `lr` for `steps` steps, in the plan's dtype;
    `on_step(step, loss, r_hat)` is called after each step.
    """
    denom = torch.mean(x_obs * x_obs)
    b1, b2, eps = 0.9, 0.999, 1e-8
    theta = torch.log(torch.tensor(r_init, dtype=fplan.scale.dtype,
                                   device=fplan.scale.device))
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    history, r_history = [], []
    loss = float("nan")
    for t in range(1, steps + 1):
        leaf = theta.detach().requires_grad_()
        x_m = _model_outputs(fplan, cfg, b, torch.exp(leaf))
        value = torch.mean((x_m - x_obs) ** 2) / denom
        (g,) = torch.autograd.grad(value, leaf)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        theta = theta - lr * mhat / (torch.sqrt(vhat) + eps)
        loss = float(value.detach())
        r_now = float(torch.exp(theta))
        history.append(loss)
        r_history.append(r_now)
        if on_step is not None:
            on_step(t, loss, r_now)
    return WireCalibration(r_hat=float(torch.exp(theta)), loss=loss,
                           history=tuple(history),
                           r_history=tuple(r_history), steps=steps)


def calibrate_wire(a, *, r_true: float = 1.0,
                   cfg: Optional[AnalogConfig] = None,
                   stages: Optional[int] = None, num_probes: int = 8,
                   generator: Optional[torch.Generator] = None,
                   r_init: float = 0.25, lr: float = 0.05, steps: int = 150,
                   on_step: Optional[Callable[[int, float, float],
                                              None]] = None,
                   device="cuda") -> WireCalibration:
    """Plant r_true in the exact nodal oracle, recover it by descent.

    Programs `a` cleanly (sigma 0, no faults) on `device`, takes the
    "measurements" by finalizing the same FlatPlan under
    `wire_model="nodal"` at the planted resistance, then fits r_hat to
    them with `calibrate_wire_to`.  `generator` (default: seeded 0) draws
    the programming noise (none, when clean) and then the (n, num_probes)
    normal probes.
    """
    a = torch.as_tensor(a, device=resolve_device(device))
    n = a.shape[0]
    if cfg is None:
        cfg = AnalogConfig(array_size=max(8, n // 2))
    clean = cfg.with_(nonideal=NonidealConfig())
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    fplan = blockamc.build_flat_plan(a, generator, clean, stages)
    b = torch.randn((n, num_probes), generator=generator, dtype=a.dtype,
                    device=generator.device).to(a.device)
    # the oracle: the exact nodal readout of the same conductances
    oracle_cfg = clean.with_(nonideal=NonidealConfig(
        r_wire=float(r_true), wire_model="nodal"))
    fin_oracle = blockamc.finalize(fplan, oracle_cfg)
    x_obs = blockamc.execute_arena(blockamc.compile_arena(fin_oracle), b)
    return calibrate_wire_to(fplan, clean, b, x_obs, r_init=r_init, lr=lr,
                             steps=steps, on_step=on_step)
