"""Replica placement and mesh shapes as device counts change, as in
`repro/runtime/elastic.py`.

`ElasticMesh.choose_shape` picks the best (data, model) factorisation for
the surviving device count given the model's divisibility constraints;
`assign_replicas` places serving replicas on the card pool round-robin.
The reference's `make_mesh` (a `jax.sharding.Mesh`) waits for the port's
sharded paths.
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
