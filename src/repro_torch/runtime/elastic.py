"""Replica placement and mesh shapes as device counts change, as in
`repro/runtime/elastic.py`.

Elasticity is restart-path, as in the reference: on a capacity change
the job checkpoints (or uses the last one), re-launches with a new mesh,
and `restore_checkpoint(..., sharding_tree=)` lays every leaf out on it.
`ElasticMesh.choose_shape` picks the best (data, model) factorisation for
the surviving device count given the model's divisibility constraints;
`make_mesh` builds that ("data", "model") `DeviceMesh` over the first
data x model ranks; `assign_replicas` places serving replicas on the card
pool round-robin.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass
class ElasticMesh:
    """Chooses mesh shapes as device counts change."""
    model_axis_candidates: Tuple[int, ...] = (16, 8, 4, 2, 1)
    min_model_axis: int = 1

    def choose_shape(self, n_devices: int,
                     model_divisors: Tuple[int, ...] = ()) -> Tuple[int, int]:
        """(data, model) with model as large as divisibility allows."""
        for m in self.model_axis_candidates:
            if m < self.min_model_axis or n_devices % m:
                continue
            if model_divisors and any(d % m for d in model_divisors):
                continue
            return (n_devices // m, m)
        return (n_devices, 1)

    def make_mesh(self, devices: Optional[List[int]] = None,
                  model_divisors: Tuple[int, ...] = (), device="cuda"):
        """A ("data", "model") `DeviceMesh` of `choose_shape`'s shape over
        the first data x model of `devices` (ranks of the world; default
        every rank).  Starts a one-rank group for `device` where none
        exists, as `launch/mesh.py` does."""
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.launch.mesh import _world
        dev, world = _world(device)
        ranks = list(range(world)) if devices is None else list(devices)
        data, model = self.choose_shape(len(ranks), model_divisors)
        grid = torch.tensor(ranks[:data * model]).reshape(data, model)
        return DeviceMesh(dev.type, grid, mesh_dim_names=("data", "model"))

    def assign_replicas(self, n_replicas: int,
                        devices: Optional[List] = None) -> List:
        """One device per serving replica, round-robin over the pool.

        The default pool is every CUDA card of the host.  With fewer
        devices than replicas the pool wraps (one card: every replica
        shares cuda:0; the tests' pool [cpu]); with more, replicas land on
        distinct cards.  Placement is deterministic in (n_replicas, pool
        order) so fleet chaos runs are replayable.  An empty pool raises.
        """
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("no devices to place replicas on")
        return [devices[i % len(devices)] for i in range(n_replicas)]
