"""Device meshes over `torch.distributed` ranks, as `repro/launch/mesh.py`
builds `jax.make_mesh` ones.

A mesh here is a `torch.distributed.device_mesh.DeviceMesh` over the
ranks of the process group: one rank a device, NCCL on the card, gloo on
the host.  Functions, not module-level constants: importing this module
starts no group and touches no card.

Where no process group exists yet, `make_mc_mesh` starts a one-rank group
through an in-process store (no address, no port), so a single process
runs the sharded solvers as a mesh of one; the caller destroys it
(`torch.distributed.destroy_process_group()`) when done.  A multi-rank
group is the caller's to start, with its address, world size and rank.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

_LM_MESH = "the language model's mesh is not ported yet (ROADMAP.md queue 1)"


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16x16 (or 2x16x16) TPU mesh: not ported yet."""
    raise NotImplementedError(f"make_production_mesh: {_LM_MESH}")


def make_host_mesh(data: int = 1, model: int = 1):
    """The reference's ("data", "model") host mesh: not ported yet."""
    raise NotImplementedError(f"make_host_mesh: {_LM_MESH}")


def make_mc_mesh(n_devices: Optional[int] = None, axis_name: str = "mc",
                 device="cuda"):
    """1-D mesh named `(axis_name,)` for sharding a Monte-Carlo key or
    instance axis (the `*_sharded` solvers): every rank of the world, one
    device each.  `n_devices` (default: the world size) must equal the
    world size.  Where no process group exists it starts a one-rank group
    for `device` (NCCL on the card, gloo on the host) over an in-process
    store, which the caller destroys.
    """
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1,
                                rank=0)
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"n_devices={n_devices}: the mesh spans the whole "
                         f"world of {world} rank(s)")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (n_devices,),
                            mesh_dim_names=(axis_name,))
