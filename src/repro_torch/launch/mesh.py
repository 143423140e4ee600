"""Device meshes over `torch.distributed` ranks, as `repro/launch/mesh.py`
builds `jax.make_mesh` ones.

A mesh here is a `torch.distributed.device_mesh.DeviceMesh` over the
ranks of the process group: one rank a device, NCCL on the card, gloo on
the host.  Functions, not module-level constants: importing this module
starts no group and touches no card.

Where no process group exists yet, each builder starts a one-rank group
through an in-process store (no address, no port), so a single process
runs the sharded paths as a mesh of one; the caller destroys it
(`torch.distributed.destroy_process_group()`) when done.  A multi-rank
group is the caller's to start, with its address, world size and rank.
A mesh spans the whole world: a world of another size raises, never a
smaller mesh.  NCCL takes one rank a card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def _world(device):
    """The world's size, starting a one-rank group for `device` (NCCL on
    the card, gloo on the host) over an in-process store if none exists,
    and pinning this rank's card."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1,
                                rank=0)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return dev, dist.get_world_size()


def _mesh(dev, shape, names, what):
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"{what}: a {shape} mesh needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks with a leading 'pod'
    axis.  The world must hold exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev, _ = _world(device)
    return _mesh(dev, shape, axes, "make_production_mesh")


def make_host_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A ("data", "model") mesh of data x model ranks: the whole world,
    which must hold exactly that many (a one-rank group is started where
    none exists, which the caller destroys)."""
    dev, _ = _world(device)
    return _mesh(dev, (data, model), ("data", "model"), "make_host_mesh")


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
    dev, world = _world(device)
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"n_devices={n_devices}: the mesh spans the whole "
                         f"world of {world} rank(s)")
    return init_device_mesh(dev.type, (n_devices,),
                            mesh_dim_names=(axis_name,))
