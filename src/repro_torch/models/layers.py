"""Common neural layers, functional style (params are plain dicts of
tensors), as `repro/models/layers.py`.

`mm` and `einsum` promote their operands to a common dtype first, as JAX
does (bfloat16 with float32 gives float32), where torch would refuse
mixed types: a float32 cache under bfloat16 weights, as the
continuous-batching engine keeps it, computes as in the reference.

Under a sharding policy `mm` multiplies DTensors on each rank's shards
with the layouts FSDP and tensor parallelism mean (`sharding.api.matmul`:
a split sequence stays split, or is gathered into a projection whose
features the model axis splits, Megatron-SP's boundary); a block with
several such projections of one input gathers its sequence once itself
(`sharding.api.seq_whole`).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.sharding.api import matmul, seq_whole


def _common(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the operands' promoted dtype; DTensors on each rank's
    shards (module docstring)."""
    a, b = _common(a, b)
    return matmul(a, b)


def einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """torch.einsum in the operands' promoted dtype."""
    return torch.einsum(eq, *_common(*xs))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype
               ) -> torch.Tensor:
    """Normal(0, 1/d_in) weights drawn in float32 from `gen` on its device,
    then cast."""
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def swiglu_ffn_init(gen: torch.Generator, d_model: int, d_ff: int, dtype
                    ) -> Dict:
    """Draws gate, up, down in that order."""
    return {
        "gate": init_dense(gen, d_model, d_ff, dtype),
        "up": init_dense(gen, d_model, d_ff, dtype),
        "down": init_dense(gen, d_ff, d_model, dtype),
    }


def swiglu_ffn(params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = seq_whole(x)
    h = F.silu(mm(x, params["gate"])) * mm(x, params["up"])
    return mm(h, params["down"])


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, D), positions: (..., S).  The
    angles are float32; the rotation computes in float32 and casts back."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].to(torch.float32) * freqs   # (..., S, half)
    angles = angles[..., None, :]                             # (..., S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)
