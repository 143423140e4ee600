"""Pipeline parallelism: GPipe stage execution over a mesh axis, as
`repro/train/pipeline.py`.

The axis' ranks host pipeline stages: stage s holds layers
[s*L/S, (s+1)*L/S) (`split_stages`), and microbatches stream through the
ring of ranks.  The schedule is GPipe's fill / steady / drain: M
microbatches over S stages complete in M + S - 1 ticks; at tick t stage 0
injects microbatch min(t, M-1), every stage applies its layers, the last
stage banks microbatch t - S + 1 once t >= S - 1, and each stage passes
its output to the next (the last wraps to stage 0, which ignores it).

The stage index and the stage count are the rank's place on the axis and
the axis' size (`DeviceMesh.get_local_rank`, `.size`), as `shard_map`
gives them to the reference.  Its `ppermute` is `_RingShift`, an
autograd function: the forward sends to the next stage and receives from
the previous one (`dist.batch_isend_irecv` over the axis' group), the
backward is the reverse ring - JAX's transpose rule for `ppermute` - so
a backward through `pipeline_apply` is pipeline-parallel backprop.
Every rank must run the backward too (its zeros included: the banked
outputs are selected with `torch.where`, so each rank's output is tied
to its stages); each walks its ring steps in reverse tick order, which
matches the sends with the receives.  A one-rank axis passes the value
to itself with no collective.

Stages must be shape-preserving ((B, ...) -> (B, ...)), which transformer
blocks are.  Full activation stash per in-flight microbatch, as the
reference.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def _ring(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Every rank of `group` sends `x` to the rank `shift` places on and
    returns what the rank `shift` places back sent it."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """ppermute i -> i + 1 over a group; its gradient goes i + 1 -> i."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _ring(grad, ctx.group, -1), None


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                   mesh, axis_name: str) -> torch.Tensor:
    """Run M microbatches through S pipeline stages on `mesh`'s axis
    `axis_name`; every rank of the axis calls it.

    Args:
      stage_fn: (params_local, x) -> y, shape-preserving.
      stage_params: this rank's stage parameters.
      x_micro: (M, ...) microbatch inputs (read on stage 0).
    Returns:
      (M, ...) final-stage outputs (meaningful on the LAST stage; zeros
      elsewhere - callers reduce or select).
    """
    group = mesh.get_group(axis_name)
    s_idx = mesh.get_local_rank(axis_name)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis_name))
    m = x_micro.shape[0]
    first = torch.tensor(s_idx == 0, device=x_micro.device)
    recv = torch.zeros_like(x_micro[0])
    outs = [torch.zeros_like(x_micro[0]) for _ in range(m)]
    for t in range(m + n_stages - 1):
        x_in = torch.where(first, x_micro[min(t, m - 1)], recv)
        y = stage_fn(stage_params, x_in)
        done = max(0, min(t - (n_stages - 1), m - 1))
        is_done = s_idx == n_stages - 1 and t >= n_stages - 1
        outs[done] = torch.where(torch.tensor(is_done, device=y.device),
                                 y, outs[done])
        recv = _RingShift.apply(y, group)
    return torch.stack(outs)


def split_stages(layer_params, n_stages: int):
    """Split a stacked (L, ...) layer-param tree into (S, L/S, ...)."""

    def split(x):
        n = x.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             f"stages")
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])

    return tree_map(split, layer_params)
