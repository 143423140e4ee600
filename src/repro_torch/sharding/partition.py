"""Monte-Carlo solver sharding, as the `mc_*_specs` of
`repro/sharding/partition.py`, and the two steps the port's sharded
solvers take with them: a rank's share of its inputs, and the shares
gathered back in rank order.

A spec names, leaf by leaf, how an input lies over a 1-D mesh axis: the
axis name for a leaf split along its leading (key or instance) axis, None
for a leaf every rank holds whole.  The reference hands its specs to
`shard_map`; here each rank runs the unsharded function on its share
(`take_share`) and `gather_shares` concatenates every rank's output along
the axis, so each rank ends with the whole result.  The leading axis must
divide evenly over the mesh axis, as in the reference.

The language model's specs (`param_spec` ... `batch_sharding`) are not
ported yet (ROADMAP.md queue 1, the language model's mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


def mc_solve_specs(axis_name: str = "mc"):
    """Specs of a Monte-Carlo BlockAMC sweep, `(partitioned_system, b,
    generators) -> solutions`: the system and right-hand sides are whole
    on every rank; only the generators (one a simulation) are split, so
    each rank programs and solves its own draws.  (in_specs, out_spec)."""
    return (None, None, axis_name), axis_name


def mc_packed_specs(pp, axis_name: str = "mc"):
    """Specs of a packed multi-tenant arena execution, `(packed_plan, bs)
    -> xs`: the plan's operator stacks, scales and whole-schedule operator
    sequence and the (M, n, k) rhs stack are split along their instance
    axis; the shared window-program metadata is whole on every rank.  The
    plan's spec is the plan with each tensor leaf replaced by its spec."""
    plan_spec = dataclasses.replace(
        pp, stacks=tuple(axis_name for _ in pp.stacks), scale=axis_name,
        program_ops=None if pp.program_ops is None else axis_name,
        program_meta=None if pp.program_meta is None
        else tuple(None for _ in pp.program_meta))
    return (plan_spec, axis_name), axis_name


def mc_refined_specs(axis_name: str = "mc"):
    """Specs of a Monte-Carlo hybrid refined solve, `(a,
    partitioned_system, b, generators) -> KrylovResult`: as
    `mc_solve_specs` with the dense matrix whole on every rank; every
    field of the result is split along the key axis."""
    return (None, None, None, axis_name), axis_name


def axis_size(mesh, axis_name: str) -> int:
    """The size of `mesh`'s axis `axis_name`."""
    return mesh.shape[mesh.mesh_dim_names.index(axis_name)]


def mc_rank(mesh, axis_name: str, n: int, what: str, device):
    """(mesh, this rank's index on the axis, the axis' size) for a sharded
    solve over `n` keys or instances; raises, as the reference does, when
    n does not divide over the axis.  mesh=None builds `make_mc_mesh` for
    `device` (starting a one-rank group if none exists)."""
    if mesh is None:
        from repro_torch.launch.mesh import make_mc_mesh
        mesh = make_mc_mesh(axis_name=axis_name, device=device)
    count = axis_size(mesh, axis_name)
    if n % count:
        raise ValueError(f"{what}={n} must divide over the {axis_name!r} "
                         f"mesh axis of size {count}")
    return mesh, mesh.get_local_rank(axis_name), count


def _share(n: int, index: int, count: int) -> slice:
    if n % count:
        raise ValueError(f"a leading axis of {n} must divide over the "
                         f"mesh axis of size {count}")
    per = n // count
    return slice(index * per, (index + 1) * per)


def take_share(x: Any, spec: Any, index: int, count: int) -> Any:
    """Rank `index` of `count`'s share of `x` by `spec`: a leaf whose spec
    is an axis name is cut along its leading axis, one whose spec is None
    is kept whole; tuples, lists and packed plans are taken leaf by leaf."""
    if spec is None:
        return x
    if isinstance(x, (tuple, list)) and isinstance(spec, (tuple, list)):
        return type(x)(take_share(a, s, index, count)
                       for a, s in zip(x, spec))
    if dataclasses.is_dataclass(x) and hasattr(x, "num_instances"):
        share = _share(x.num_instances, index, count)
        fields = ("stacks", "scale", "program_ops", "program_meta")
        return dataclasses.replace(
            x, num_instances=share.stop - share.start,
            **{f: take_share(getattr(x, f), getattr(spec, f), index, count)
               for f in fields})
    if isinstance(x, (list, tuple)):            # a leaf list (generators)
        return x[_share(len(x), index, count)]
    return x[_share(x.shape[0], index, count)]


def gather_shares(x: Any, mesh, axis_name: str = "mc") -> Any:
    """Every rank's share of `x` (a tensor, or a tuple / NamedTuple of
    them) concatenated along the leading axis in rank order, on every rank
    of `mesh`'s axis.  Boolean leaves travel as uint8."""
    if isinstance(x, tuple):
        gathered = [gather_shares(f, mesh, axis_name) for f in x]
        return type(x)(*gathered) if hasattr(x, "_fields") \
            else tuple(gathered)
    group = mesh.get_group(axis_name)
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    wire = wire.contiguous()
    parts = [torch.empty_like(wire) for _ in range(axis_size(mesh,
                                                             axis_name))]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts).to(x.dtype)
