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
implicit-replication switch, the local-shape helper, the shape
propagation `shape_propagation` marks) are reached from this module
only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


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


def is_dtensor_type(cls) -> bool:
    """Whether `cls` (a type a dispatch mode is handed) is DTensor's."""
    return issubclass(cls, DTensor)


@contextlib.contextmanager
def shape_propagation(hook):
    """Inside, DTensor's propagation of an op's output shape - it runs a
    fake copy of the op on global shapes - runs within the context
    `hook()` returns, so that a dispatch mode can tell those ops from the
    rank's own work (`launch/hlo_analysis.py`)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = next(n for n in ("_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta")
                if hasattr(ShardingPropagator, n))
    inner = ShardingPropagator.__dict__[name]

    def hooked(self, *args, **kwargs):
        with hook():
            return inner(self, *args, **kwargs)
    setattr(ShardingPropagator, name, hooked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, inner)


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
    [offset, offset + shape) of the global tensor.  An even split (every
    split the port makes) is worked out from the mesh coordinate alone,
    with no tensor op, so that it also runs under a `FakeTensorMode` (the
    dry run); an uneven one is DTensor's own."""
    mesh, place = x.device_mesh, x.placements
    size, off = list(x.shape), [0] * x.dim()
    coord = mesh.get_coordinate()
    for j, p in enumerate(place):
        if not p.is_shard():
            continue
        if size[p.dim] % mesh.size(j):
            from torch.distributed.tensor._utils import \
                compute_local_shape_and_global_offset
            return compute_local_shape_and_global_offset(x.shape, mesh,
                                                         place)
        size[p.dim] //= mesh.size(j)
        off[p.dim] += coord[j] * size[p.dim]
    return tuple(size), tuple(off)


def on_local(fn, x: DTensor, *others, split, place=None) -> DTensor:
    """fn(x's local shard, *others) as a DTensor on x's mesh with
    `place` (default: x's placements); a tuple of results as a tuple of
    DTensors, each with `place` or with its own placements where `place`
    is a tuple of placement lists.  Each DTensor among `others` is
    passed as its local shard, anything else as it is; x may be split
    along the tensor dims in `split` only (a ValueError otherwise), so
    that `fn` sees whole what it must.  The result keeps the gradient:
    its backward hands `fn` the local gradient, and an input whole on a
    mesh dim over which the result varies (split or partial) gets its
    gradient there as a partial sum - each rank's share of it, as the
    weights of a product over each rank's rows."""
    bad = [p for p in x.placements if p.is_shard() and p.dim not in split]
    if bad:
        raise ValueError(f"{getattr(fn, '__name__', fn)} takes a tensor "
                         f"split along dims {tuple(split)} only, not "
                         f"{tuple(x.placements)}")
    place = x.placements if place is None else place
    each = (tuple(list(pl) for pl in place)
            if isinstance(place[0], (list, tuple)) else None)
    varies = [any(not pl[j].is_replicate() for pl in (each or [place]))
              for j in range(x.device_mesh.ndim)]

    def local(t):
        if not is_dtensor(t):
            return t
        return t.to_local(grad_placements=[
            Partial() if p.is_replicate() and v
            else Replicate() if p.is_partial() else p
            for p, v in zip(t.placements, varies)])
    out = fn(local(x), *(local(o) for o in others))
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, x.device_mesh, pl,
                                        run_check=False)
                     for o, pl in zip(out, each or [place] * len(out)))
    return DTensor.from_local(out, x.device_mesh, place, run_check=False)


def seq_whole(x: torch.Tensor) -> torch.Tensor:
    """x (B, ..., F) with every split of the dims between the first and
    the last gathered: the sequence of Megatron-SP or context parallelism
    gathered into a projection, as the reference's layouts do at the
    block's boundary.  torch's matmul flattens the leading dims, and
    DTensor's rules take no flatten of a split sequence.  Anything else
    is returned as it is."""
    if not is_dtensor(x) or x.dim() < 3:
        return x
    mid = range(1, x.dim() - 1)
    if not any(p.is_shard() and p.dim in mid for p in x.placements):
        return x
    return lay_out(x, x.device_mesh, [
        Replicate() if p.is_shard() and p.dim in mid else p
        for p in x.placements])


def matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ w (K, N), a DTensor pair on each rank's shards with the
    reference's FSDP and tensor-parallel layouts.  Over each mesh dim:
    rows of a split there stay split (w gathered there: FSDP's all-gather
    before use, whose backward reduce-scatters the gradient); a K split
    of a gives a partial sum (w split alike, row-parallel); with a whole,
    w's N split stays (column-parallel) and its K split takes a's K alike
    (a local slice of a and a partial sum, where gathering w would repeat
    the product on every rank).  A sequence split over a mesh dim that
    splits w's N is gathered first (Megatron-SP's boundary into a
    projection).  The local product flattens only local tensors: DTensor's
    own rule takes no flatten of a split sequence, and for a small
    activation may split the contraction and hold every row's product on
    every rank.  Other operands go to torch.matmul."""
    if not (is_dtensor(a) and is_dtensor(w)) or w.dim() != 2:
        return torch.matmul(a, w)
    mesh, last = a.device_mesh, a.dim() - 1
    a = lay_out(a, mesh, [
        Replicate() if p.is_partial() or (
            p.is_shard() and 0 < p.dim < last and q.is_shard(1)) else p
        for p, q in zip(a.placements, w.placements)])
    w_place, out = [], []
    for p, q in zip(a.placements, w.placements):
        if p.is_shard(last):
            w_place.append(Shard(0))
            out.append(Partial())
        elif p.is_shard():
            w_place.append(Replicate())
            out.append(Shard(p.dim))
        elif q.is_shard(1):
            w_place.append(q)
            out.append(Shard(last))
        elif q.is_shard(0):
            w_place.append(q)
            out.append(Partial())
        else:
            w_place.append(Replicate())
            out.append(Replicate())
    a = lay_out(a, mesh, [Shard(last) if o.is_partial() else p
                          for p, o in zip(a.placements, out)])
    return on_local(torch.matmul, a, lay_out(w, mesh, w_place),
                    split=range(a.dim()), place=out)


def split_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (B, ...) as (n, B // n, ...): part i is rows [i*B/n, (i+1)*B/n),
    as `x.reshape(n, B // n, ...)`.  A DTensor comes back split along its
    dim 1 as x is along dim 0 (its other splits one dim on), so that
    indexing part i (`take`) needs no communication.  Where one mesh dim
    splits x's rows and B/n divides over it, each rank's rows go where
    they belong in one all-to-all over that dim (x's own bytes, never the
    whole batch); otherwise the rows are gathered first."""
    b = x.shape[0]
    if not is_dtensor(x):
        return x.reshape((n, b // n) + tuple(x.shape[1:]))
    mesh, place = x.device_mesh, list(x.placements)
    rows = [j for j, p in enumerate(place) if p.is_shard(0)]
    ways = math.prod(mesh.size(j) for j in rows)
    if len(rows) > 1 or (b // n) % ways:
        out = split_rows(lay_out(x, mesh, [
            Replicate() if p.is_shard(0) else p for p in place]), n)
        return lay_out(out, mesh, _fit([
            Shard(1) if j in rows else p
            for j, p in enumerate(out.placements)], out.shape, mesh))
    local = x.to_local()
    rest = tuple(local.shape[1:])
    if rows:
        local = _rows_to_parts(local, n, mesh, rows[0])
    local = local.reshape((n, local.shape[0] // n) + rest)
    return DTensor.from_local(local, mesh, [
        Shard(p.dim + 1) if p.is_shard() else p for p in place],
        run_check=False)


def _rows_to_parts(local: torch.Tensor, n: int, mesh, j: int
                   ) -> torch.Tensor:
    """Rank c of mesh dim j (of size P) holds rows [c*B/P, (c+1)*B/P) of
    B; returns the rows it holds of each of the n parts of B (rows
    [c*q, (c+1)*q) of each part, q = B/(n P)), parts in order.  Row block
    k = c*n + a (a < n, q rows each) belongs to rank k % P, part k // P;
    one all-to-all over the dim moves every block, and each rank receives
    its n blocks in part order (source rank, then a, both ascending)."""
    p, c = mesh.size(j), mesh.get_local_rank(j)
    if p == 1:
        return local
    q = local.shape[0] // n
    dest = [(c * n + a) % p for a in range(n)]
    order = sorted(range(n), key=lambda a: dest[a])
    blocks = local.reshape((n, q) + tuple(local.shape[1:]))
    send = (local if order == list(range(n))
            else torch.cat([blocks[a] for a in order])).contiguous()
    send_counts = [q * dest.count(r) for r in range(p)]
    recv_counts = [q * sum((src * n + a) % p == c for a in range(n))
                   for src in range(p)]
    out = torch.empty((n * q,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    dist.all_to_all_single(out, send, recv_counts, send_counts,
                           group=mesh.get_group(j))
    return out


def take(x: torch.Tensor, i: int) -> torch.Tensor:
    """Part i of `split_rows`' result: x[i], on each rank's shard for a
    DTensor (dim 0 must be whole)."""
    if not is_dtensor(x):
        return x[i]
    return on_local(lambda t: t[i], x, split=range(1, x.dim()), place=[
        Shard(p.dim - 1) if p.is_shard() else p for p in x.placements])


def argmax(x: torch.Tensor) -> torch.Tensor:
    """torch.argmax over the last dim.  A DTensor split along it is
    reduced on each rank's shard: the shard's first largest value and its
    global index, gathered along the split (one pair a row a rank), then
    the first of the largest, as `torch.argmax` takes it; the result is
    whole on every rank.  DTensor's own rule for it differs between torch
    releases and reads offsets back from tensors, which no fake tensor
    holds."""
    last = x.dim() - 1
    if not is_dtensor(x) or not any(p.is_shard(last) for p in x.placements):
        return torch.argmax(x, dim=-1)
    _, off = local_box(x)
    val, idx = torch.max(x.to_local(), dim=-1, keepdim=True)
    vals, idxs = (whole(DTensor.from_local(t, x.device_mesh, x.placements,
                                           run_check=False))
                  for t in (val, idx + off[last]))
    pick = torch.argmax(vals, dim=-1, keepdim=True)
    return torch.gather(idxs, -1, pick)[..., 0]


def shard(x: torch.Tensor, name: str) -> torch.Tensor:
    """x laid out by the active policy's rule for `name` (the identity
    with no policy or an unbound name), and so is its gradient."""
    pol = _ACTIVE
    if pol is None:
        return x
    spec = pol.rules.get(name)
    if spec is None:
        return x
    from repro_torch.sharding.partition import placements
    place = placements(spec, pol.mesh)
    x = lay_out(x, pol.mesh, _fit(place, x.shape, pol.mesh))
    if torch.is_grad_enabled() and x.requires_grad:
        # the gradient laid out as x too, whatever layout it arrives in
        # (a partial sum reduced here), as the reference's constraint
        # binds both directions; the forward moves nothing
        x = DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                               run_check=False, shape=x.shape,
                               stride=x.stride())
    return x


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
