"""AdamW on nested dicts of tensors, as `repro/optim/adamw.py`, with a
configurable moment dtype (bfloat16 moments halve the optimizer state).

The update is the reference's arithmetic, not `torch.optim.AdamW`'s:
moments stored in `moments_dtype`, every update computed in float32 from
float32 copies, bias corrections from a float32 step, weight decay on
tensors of two or more dimensions only, parameters cast back to their own
dtype.  It is functional - `update` returns new parameters and a new
state and leaves its arguments as they were - and runs under
`torch.no_grad()`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor      # 0-d int32, on the parameters' device
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moments_dtype: torch.dtype = torch.float32

    def init(self, params) -> OptState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.moments_dtype,
                               device=p.device)
        device = next(tree_leaves(params)).device
        return OptState(step=torch.zeros((), dtype=torch.int32,
                                         device=device),
                        m=tree_map(zeros, params), v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: OptState, params,
               lr_scale: torch.Tensor | float = 1.0
               ) -> Tuple[Any, OptState]:
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** step.to(torch.float32)
        bc2 = 1.0 - b2 ** step.to(torch.float32)
        lr = self.lr * lr_scale
        f32 = torch.float32

        def upd(g, m, v, p):
            g32 = g.to(f32)
            m32 = b1 * m.to(f32) + (1 - b1) * g32
            v32 = b2 * v.to(f32) + (1 - b2) * torch.square(g32)
            mh = m32 / bc1
            vh = v32 / bc2
            delta = mh / (torch.sqrt(vh) + self.eps)
            if p.ndim >= 2:   # decay matrices only (standard practice)
                delta = delta + self.weight_decay * p.to(f32)
            new_p = (p.to(f32) - lr * delta).to(p.dtype)
            return (new_p, m32.to(self.moments_dtype),
                    v32.to(self.moments_dtype))

        out = tree_map(upd, grads, state.m, state.v, params)
        new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out)
                               for i in range(3))
        return new_p, OptState(step=step, m=new_m, v=new_v)
