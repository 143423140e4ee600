"""Partitioning, as `repro/sharding/partition.py`: the language model's
rules, and the Monte-Carlo solver's `mc_*_specs` with the two steps the
port's sharded solvers take with them: a rank's share of its inputs, and
the shares gathered back in rank order.

A Monte-Carlo spec names, leaf by leaf, how an input lies over a 1-D mesh axis: the
axis name for a leaf split along its leading (key or instance) axis, None
for a leaf every rank holds whole.  The reference hands its specs to
`shard_map`; here each rank runs the unsharded function on its share
(`take_share`) and `gather_shares` concatenates every rank's output along
the axis, so each rank ends with the whole result.  The leading axis must
divide evenly over the mesh axis, as in the reference.

The language model's rules (`param_spec` ... `batch_sharding`) are the
reference's, path pattern -> `PartitionSpec`:

  * TP over "model": projection output features, the expert axis (EP),
    the vocabulary;
  * optional FSDP/ZeRO over "data": the other large dim of each matrix
    (moments follow their parameters);
  * DP across "pod": parameters replicated, activations batch-sharded.

Every rule checks divisibility against the mesh's axis sizes and falls
back to replication rather than an uneven split (DTensor would take one;
the port never asks it to).  A spec is the port's own `PartitionSpec`, a
tuple with one entry a tensor dim: None, an axis name, or a tuple of axis
names (one tensor dim split over several mesh dims, the first named
major).  `placements(spec, mesh)` turns it into DTensor placements over a
`DeviceMesh` with the same axis names: each mesh dim gets `Shard(i)` if
tensor dim i names its axis, else `Replicate()`.  `NamedSharding` pairs a
spec with its mesh, as `jax.sharding.NamedSharding` does.  A mesh here is
a `DeviceMesh` (`launch/mesh.py`); the rules read only its axis names and
sizes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, RunConfig


class PartitionSpec(tuple):
    """How a tensor lies over a mesh, one entry a tensor dim (None, an
    axis name or a tuple of them); trailing dims left out are whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh`."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec, mesh) -> list:
    """DTensor placements of `spec` over `mesh`: mesh dim j gets Shard(i)
    where tensor dim i names its axis (alone or in a tuple), else
    Replicate().  A tuple must name its axes in the mesh's order, which
    DTensor's default order of several shards on one dim follows."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        group = ax if isinstance(ax, tuple) else (ax,)
        where = [names.index(a) for a in group]
        if where != sorted(where):
            raise ValueError(f"spec {spec}: the axes {group} must come in "
                             f"the mesh's order {tuple(names)}")
        for j in where:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"spec {spec} names axis {names[j]!r} "
                                 f"twice")
            out[j] = Shard(dim)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as `jax.sharding.NamedSharding`."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def _axis_size(mesh, name: Optional[str]) -> int:
    return 1 if name is None else axis_size(mesh, name)


def _ok(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    if isinstance(axis, tuple):
        size = math.prod(_axis_size(mesh, a) for a in axis)
    else:
        size = _axis_size(mesh, axis)
    return dim % size == 0


def _spec(shape, mesh, *axes) -> PartitionSpec:
    """A spec, dropping any axis that doesn't divide its dim."""
    return P(*(ax if _ok(dim, mesh, ax) else None
               for dim, ax in zip(shape, axes)))


def param_spec(path: str, shape: Tuple[int, ...], mesh,
               fsdp: bool) -> PartitionSpec:
    """Sharding rule for one parameter leaf (path uses '/' separators).

    Stacked params carry a leading layer dim -> leading None.
    """
    dp = "data" if fsdp else None
    shape = tuple(shape)
    lead: Tuple = ()
    if "blocks/" in path:                # stacked repeats: (L, ...)
        lead = (None,)
        shape = shape[1:]

    leaf = path.split("/")[-1]

    if leaf in ("embed",):               # (V, d)
        return _spec(lead + shape, mesh, *lead, "model", dp)
    if leaf in ("head",):                # (d, V)
        return _spec(lead + shape, mesh, *lead, dp, "model")
    if leaf in ("wq", "wk", "wv", "w_y", "w_u", "w_a", "w_x", "in_proj"):
        return _spec(lead + shape, mesh, *lead, dp, "model")
    if leaf in ("wo", "w_o", "out_proj"):
        return _spec(lead + shape, mesh, *lead, "model", dp)
    if leaf in ("gate", "up", "down"):
        if len(shape) == 3:              # MoE experts: (E, d, f)
            return _spec(lead + shape, mesh, *lead, "model", dp, None)
        if leaf == "down":               # (f, d)
            return _spec(lead + shape, mesh, *lead, "model", dp)
        return _spec(lead + shape, mesh, *lead, dp, "model")
    if leaf == "router":                 # (d, E): replicate E (small)
        return _spec(lead + shape, mesh, *lead, dp, None)
    if leaf == "conv_w" or shape == ():
        return P()
    if len(shape) == 1:                  # norms, biases, scalars
        return _spec(lead + shape, mesh, *lead, None)
    # default 2D: shard last dim on model if divisible
    return _spec(lead + shape, mesh, *lead, dp, "model")


def _with_paths(fn, tree, prefix: str = ""):
    """`tree` (nested dicts and namedtuples) with each leaf replaced by
    fn(path, leaf), the path its keys and field names joined by '/'."""
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_with_paths(fn, v, f"{prefix}{f}/")
                            for f, v in zip(tree._fields, tree)))
    return fn(prefix[:-1], tree)


def make_param_shardings(params_shape, mesh, fsdp: bool):
    """A tree of `NamedSharding`s for a parameter tree (tensors, or
    anything with a `.shape`, meta tensors included)."""
    return _with_paths(lambda path, leaf: NamedSharding(
        mesh, param_spec(path, leaf.shape, mesh, fsdp)), params_shape)


def make_state_shardings(state_shape, mesh, fsdp: bool):
    """TrainState shardings: moments follow their parameters; the step
    is replicated."""

    def one(path, leaf):
        if len(leaf.shape) == 0:
            return NamedSharding(mesh, P())
        # strip the TrainState prefix (params/..., opt/m/..., opt/v/...)
        parts = path.split("/")
        if parts[0] == "params":
            core = "/".join(parts[1:])
        elif parts[0] == "opt" and parts[1] in ("m", "v"):
            core = "/".join(parts[2:])
        else:
            core = path
        return NamedSharding(mesh, param_spec(core, leaf.shape, mesh, fsdp))

    return _with_paths(one, state_shape)


def distribute(tree, shardings):
    """Each tensor of `tree` (nested dicts and namedtuples) as a DTensor
    laid out by its `NamedSharding` in `shardings`, a tree of the same
    structure.  A plain tensor is whole on every rank, so each keeps its
    own slice: no communication; a DTensor is redistributed."""
    from repro_torch.sharding.api import lay_out
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute(a, b)
                            for a, b in zip(tree, shardings)))
    return lay_out(tree, shardings.mesh, shardings.placements)


# ---------------------------------------------------------------------------
# Activation rules + batch sharding
# ---------------------------------------------------------------------------

def activation_rules(mesh, model_cfg: ModelConfig,
                     run_cfg: RunConfig) -> Dict[str, PartitionSpec]:
    """Named activation layouts consumed by `sharding.api.shard`.

    Divisibility-aware: head-sharded attention when n_heads divides the
    model axis, otherwise context-parallel k/v (sequence dim on "model");
    MoE dispatch buffers expert-sharded (EP) when E divides.
    """
    shape = mesh_axes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in shape)
    batch: Any = batch_axes if len(batch_axes) > 1 else (
        batch_axes[0] if batch_axes else None)
    gb = run_cfg.global_batch
    bsize = math.prod(shape[a] for a in batch_axes)
    if gb % max(bsize, 1):
        batch = "data" if gb % shape.get("data", 1) == 0 else None
    tp = shape.get("model", 1)

    seq_ax = None
    if (run_cfg.seq_shard and run_cfg.mode == "train"
            and run_cfg.seq_len % max(tp, 1) == 0):
        seq_ax = "model"      # Megatron-SP: LN/residual segments S-sharded
    rules = {
        "act_btd": P(batch, seq_ax, None),
        "act_btv": P(batch, None, "model"),
    }
    if model_cfg.n_heads and model_cfg.n_heads % tp == 0:
        rules["act_q"] = P(batch, None, "model", None)
        rules["act_kv"] = P(batch, None, "model", None)
    else:
        # context parallelism: shard the sequence axis of k/v; q whole
        # along heads
        rules["act_q"] = P(batch, None, None, None)
        rules["act_kv"] = P(batch, "model", None, None)
    # decode KV cache: batch on data, sequence on model (flash-decode layout)
    rules["act_cache"] = P(batch, "model", None, None)
    if model_cfg.n_experts and model_cfg.n_experts % tp == 0:
        rules["act_ecd"] = P("model", None, None)
        # group-local MoE dispatch buffer (g, E, C, d): groups on the batch
        # axes, experts on the TP axis
        rules["act_gecd"] = P(batch, "model", None, None)
    return rules


def dp_group_count(mesh, model_cfg: ModelConfig, run_cfg: RunConfig) -> int:
    """Number of data-parallel groups for group-local MoE dispatch."""
    batch = activation_rules(mesh, model_cfg, run_cfg)["act_btd"][0]
    if batch is None:
        return 1
    axes = batch if isinstance(batch, tuple) else (batch,)
    return math.prod(mesh_axes(mesh)[a] for a in axes)


def make_policy(mesh, model_cfg: ModelConfig, run_cfg: RunConfig):
    """ShardingPolicy with the activation rules and the dp_groups hint."""
    from repro_torch.sharding.api import ShardingPolicy
    return ShardingPolicy(
        mesh=mesh, rules=activation_rules(mesh, model_cfg, run_cfg),
        meta={"dp_groups": dp_group_count(mesh, model_cfg, run_cfg)})


def batch_sharding(mesh, model_cfg: ModelConfig,
                   run_cfg: RunConfig) -> NamedSharding:
    return NamedSharding(mesh,
                         activation_rules(mesh, model_cfg, run_cfg)["act_btd"])


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
