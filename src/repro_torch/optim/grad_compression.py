"""Gradient compression: int8 quantisation with error feedback, as
`repro/optim/grad_compression.py`.

At multi-pod scale the reference reduces gradients hierarchically: full
precision within a pod, an int8-compressed sum across pods, with
per-tensor scales and an error-feedback residual so that compression
noise does not accumulate.  `compressed_psum` sums across one named
axis of a `DeviceMesh`, each rank holding its own leaves, as the
reference's runs inside `shard_map` over the "pod" axis.

The divisions are by device tensors (`numerics.over`), as `jnp` divides
by an array.  `torch.round` rounds half to even, as `jnp.round` does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

import torch.distributed as dist

from repro_torch.numerics import over
from repro_torch.tree import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = over(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(tree: Any, mesh, axis_name: str, error_state: Any
                    ) -> Tuple[Any, Any]:
    """Sum each leaf across `mesh`'s axis `axis_name` after int8
    compression with error feedback.

    Per leaf: g32 = g + err; (q, scale) = quantize_int8(g32); the
    dequantised deq is summed over the axis (an all-reduce of float32,
    as the reference's psum of deq); new_err = g32 - deq.  `error_state`
    is a tree like `tree`.  Returns (reduced tree in float32, new error
    state).
    """
    group = mesh.get_group(axis_name)

    def one(g, err):
        g32 = g.to(torch.float32) + err
        q, scale = quantize_int8(g32)
        deq = dequantize_int8(q, scale)
        total = deq.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total, g32 - deq

    out = tree_map(one, tree, error_state)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def init_error_state(tree: Any) -> Any:
    """Zero float32 residuals shaped as the leaves of `tree`."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), tree)
