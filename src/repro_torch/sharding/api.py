"""Activation-sharding policy: a scoped registry of named layouts, as
`repro/sharding/api.py`.

Model code annotates tensors by *logical* name (`shard(x, "act_btd")`); a
launcher installs a policy binding those names to `PartitionSpec`s on its
`DeviceMesh` (`sharding/partition.make_policy`).  With no policy
installed, or for a name the policy leaves unbound, `shard` is the
identity, so unit tests and single-device runs never touch a process
group.

Under a policy `shard` returns a DTensor laid out by the rule (a dim
that the rule's mesh dims do not divide evenly, or a dim of one, stays
whole, as the reference's parameter rules fall back): a DTensor is
redistributed (the collectives JAX's `with_sharding_constraint` would
have GSPMD insert), a plain tensor - which every rank holds whole - keeps
each rank's own slice with no communication.  Both are differentiable:
the backward of a plain tensor's slice gathers the whole gradient.

While a policy is in scope (`policy_scope`, or `mesh_ops` around any
DTensor work) plain tensors that meet a DTensor in one op - positions,
masks, constants, which every rank builds alike - count as replicated
(DTensor's `implicit_replication`), so model code builds them as on one
device.  A plain tensor that differs between ranks must never meet a
DTensor this way.

Where DTensor's own rules do not fit a core (attention's, the experts',
an in-place cache write), the model runs it on each rank's shards:
`on_local` checks the split, unwraps, runs and wraps the result back,
and `local_box` says which block of the global tensor a rank holds.
The DTensor internals the port relies on (the dispatcher's
implicit-replication switch, the local-shape helper) are reached from
this module only.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate


@dataclasses.dataclass
class ShardingPolicy:
    mesh: Any                       # torch.distributed DeviceMesh
    rules: Dict[str, Any]           # logical name -> PartitionSpec
    meta: Dict[str, int] = dataclasses.field(default_factory=dict)


_ACTIVE: Optional[ShardingPolicy] = None


def set_policy(policy: Optional[ShardingPolicy]) -> None:
    global _ACTIVE
    _ACTIVE = policy


def clear_policy() -> None:
    set_policy(None)


def current_policy() -> Optional[ShardingPolicy]:
    return _ACTIVE


@contextlib.contextmanager
def mesh_ops():
    """Plain tensors meeting a DTensor count as replicated inside (module
    docstring); nests, and restores the setting it found."""
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


@contextlib.contextmanager
def policy_scope(policy: ShardingPolicy):
    prev = current_policy()
    set_policy(policy)
    try:
        with (mesh_ops() if policy is not None and policy.mesh is not None
              else contextlib.nullcontext()):
            yield
    finally:
        set_policy(prev)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def lay_out(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """`x` as a DTensor on `mesh` with `placements`: a DTensor is
    redistributed; a plain tensor, whole on every rank, keeps each rank's
    slice (no communication)."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def replicated(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """`x` as a replicated DTensor: a DTensor gathered on its own mesh; a
    plain tensor - whole and alike on every rank - wrapped on `mesh` with
    no communication (returned as it is for mesh=None)."""
    if not is_dtensor(x) and mesh is None:
        return x
    mesh = x.device_mesh if is_dtensor(x) else mesh
    return lay_out(x, mesh, [Replicate()] * mesh.ndim)


def whole(x: torch.Tensor) -> torch.Tensor:
    """`x` as a plain tensor whole on every rank: a DTensor gathered, a
    plain tensor as it is.  Differentiable where the plain result's
    gradient is the same on every rank (re-wrap what leaves a plain
    region with `replicated`)."""
    return replicated(x).to_local() if is_dtensor(x) else x


def local_box(x) -> tuple:
    """(shape, offset) of this rank's shard of the DTensor `x`: the block
    [offset, offset + shape) of the global tensor."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return compute_local_shape_and_global_offset(x.shape, x.device_mesh,
                                                 x.placements)


def on_local(fn, x: DTensor, *others, split, place=None) -> DTensor:
    """fn(x's local shard, *others) as a DTensor on x's mesh with
    `place` (default: x's placements).  Each DTensor among `others` is
    passed as its local shard, anything else as it is; x may be split
    along the tensor dims in `split` only (a ValueError otherwise), so
    that `fn` sees whole what it must.  The result keeps the gradient:
    its backward hands `fn` the local gradient."""
    bad = [p for p in x.placements if p.is_shard() and p.dim not in split]
    if bad:
        raise ValueError(f"{getattr(fn, '__name__', fn)} takes a tensor "
                         f"split along dims {tuple(split)} only, not "
                         f"{tuple(x.placements)}")
    out = fn(x.to_local(), *(o.to_local() if is_dtensor(o) else o
                             for o in others))
    return DTensor.from_local(out, x.device_mesh,
                              x.placements if place is None else place,
                              run_check=False)


def shard(x: torch.Tensor, name: str) -> torch.Tensor:
    """x laid out by the active policy's rule for `name` (the identity
    with no policy or an unbound name)."""
    pol = _ACTIVE
    if pol is None:
        return x
    spec = pol.rules.get(name)
    if spec is None:
        return x
    from repro_torch.sharding.partition import placements
    place = placements(spec, pol.mesh)
    return lay_out(x, pol.mesh, _fit(place, x.shape, pol.mesh))


def _fit(place, shape, mesh) -> list:
    """`place` with each split of a dim that its mesh dims do not divide
    evenly, or of a dim of one, made Replicate(): the port never splits
    unevenly (DTensor would), and DTensor cannot reshape a split
    singleton."""
    ways = {}
    for j, p in enumerate(place):
        if p.is_shard():
            ways[p.dim] = ways.get(p.dim, 1) * mesh.size(j)
    bad = {d for d, n in ways.items()
           if d >= len(shape) or shape[d] == 1 or shape[d] % n}
    return [Replicate() if p.is_shard() and p.dim in bad else p
            for p in place]


def get_meta(name: str, default: int = 1) -> int:
    """Integer hints from the active policy (e.g. dp_groups)."""
    pol = _ACTIVE
    if pol is None:
        return default
    return pol.meta.get(name, default)
