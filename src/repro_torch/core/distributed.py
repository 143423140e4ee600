"""The vectorised tile solver of the paper's Fig. 3/5, as in
`repro/core/distributed.py`.

The two-stage BlockAMC architecture - many fixed-size arrays on a data bus,
partial MVMs recovered by summation, INV results cascaded - is written over
(rt, ct, s, s) tile tensors rather than Python tile lists, and the digital
Schur pre-processing as recursive block inversion: GEMMs and leaf-size
inverses only.  The Schur products stay plain `torch` matmuls, as the
reference leaves them to XLA.

Mesh: the reference lays the tile axes over a ("data", "model") TPU mesh
and lets XLA insert the bus traffic.  Here `mesh` is a 2-D
`torch.distributed` DeviceMesh with those axis names: each rank computes
the partial products of its tile rows (split over "data") and tile
columns (split over "model"), the partials are summed over "model"
(all-reduce) and the row blocks gathered over "data" (all-gather), so
every rank holds the whole product.  Readouts, programming and the leaf
solves stay whole on every rank.  With mesh=None nothing is split.

Random draws: `build_dist_plan` consumes one `torch.Generator` level by
level - at each level k the A2 blocks of all 2^k blocks as one stack, then
their A3 blocks as one stack - and then the 2^stages leaves as one stack;
each stack draws its positive arrays' noise, then its negative arrays'
(`analog.map_tiled_vec`).  This replaces the reference's per-level
`jax.random.split`s, so the two packages draw different noise.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.distributed as dist

from repro_torch.core.analog import AnalogConfig, TileGrid, map_tiled_vec
from repro_torch.device import resolve_device


def _mvm_tiles(a_eff: torch.Tensor, v: torch.Tensor,
               mesh=None) -> torch.Tensor:
    """-A_eff @ v over an (rt, ct, s, s) effective tile tensor: per-tile
    partial products summed along each tile row; with a mesh, split over
    its ("data", "model") axes (module docstring)."""
    rt, ct, s, _ = a_eff.shape
    vt = v.reshape(ct, s)
    if mesh is None:
        return -torch.einsum("rcij,cj->ri", a_eff, vt).reshape(rt * s)
    rows = _part(rt, mesh, "data")
    cols = _part(ct, mesh, "model")
    out = -torch.einsum("rcij,cj->ri", a_eff[rows, cols], vt[cols])
    dist.all_reduce(out, group=mesh.get_group("model"))
    return _gather_rows(out, rt, mesh).reshape(rt * s)


def _tile_slice(n: int, size: int, idx: int) -> slice:
    """Rank idx of size's contiguous part of n tiles (the first n % size
    ranks take one more, as `torch.tensor_split`)."""
    per, extra = divmod(n, size)
    lo = idx * per + min(idx, extra)
    return slice(lo, lo + per + (idx < extra))


def _axis(mesh, axis: str):
    """(size, this rank's index) of a mesh axis."""
    return (mesh.shape[mesh.mesh_dim_names.index(axis)],
            mesh.get_local_rank(axis))


def _part(n: int, mesh, axis: str) -> slice:
    """This rank's part of n tiles along a mesh axis."""
    return _tile_slice(n, *_axis(mesh, axis))


def _gather_rows(out: torch.Tensor, rt: int, mesh) -> torch.Tensor:
    """The (rt, s) product from every "data" rank's row block: blocks are
    padded to the longest, gathered in rank order and trimmed."""
    size, _ = _axis(mesh, "data")
    pad = out.new_zeros((-(-rt // size),) + tuple(out.shape[1:]))
    pad[:out.shape[0]] = out
    parts = [torch.empty_like(pad) for _ in range(size)]
    dist.all_gather(parts, pad, group=mesh.get_group("data"))
    lengths = [sl.stop - sl.start
               for sl in (_tile_slice(rt, size, i) for i in range(size))]
    return torch.cat([p[:n] for p, n in zip(parts, lengths)])


def mvm_tiled_vec(grid: TileGrid, v: torch.Tensor, cfg: AnalogConfig,
                  mesh=None) -> torch.Tensor:
    """Partitioned analog MVM: out = -A_eff @ v with per-tile partial sums
    (the 'recover the final solution' step of refs [13]-[15]); `grid` is
    (rt, ct, s, s), `v` an (ct * s,) vector.  With a ("data", "model")
    mesh the partial products are split over its ranks and the partials
    summed over "model" (module docstring)."""
    return _mvm_tiles(grid.a_eff(cfg), v, mesh)


# ---------------------------------------------------------------------------
# Digital block inversion (GEMM-only Schur recursion; the pre-processor)
# ---------------------------------------------------------------------------

def block_inv(a: torch.Tensor, leaf: int) -> torch.Tensor:
    """Recursive 2x2 block inversion - BlockAMC's identity, digitally.

      A = [[A1, A2], [A3, A4]],  S = A4 - A3 A1^-1 A2
      A^-1 = [[A1i + W S^-1 V,  -W S^-1],
              [-S^-1 V,          S^-1  ]],  W = A1i A2, V = A3 A1i

    Only GEMMs and leaf-size inverses.  The leaves use `inv_ex`, which,
    like `jnp.linalg.inv`, neither checks for singularity nor stops the
    card to read a status.
    """
    n = a.shape[0]
    if n <= leaf:
        return torch.linalg.inv_ex(a).inverse
    m = n // 2
    a1, a2 = a[:m, :m], a[:m, m:]
    a3, a4 = a[m:, :m], a[m:, m:]
    a1i = block_inv(a1, leaf)
    w = a1i @ a2
    v = a3 @ a1i
    s = a4 - a3 @ w
    si = block_inv(s, leaf)
    top = torch.cat([a1i + w @ (si @ v), -(w @ si)], dim=1)
    bot = torch.cat([-(si @ v), si], dim=1)
    return torch.cat([top, bot], dim=0)


# ---------------------------------------------------------------------------
# The tile solver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistPlan:
    """Flattened tile-solver plan: per-level tile grids.

    Level k (k = 0 .. stages-1) holds the A2 and A3 MVM grids of every
    block at that depth, stacked on a leading block axis (2^k blocks,
    each (rt, ct, s, s)); the Schur complements are folded into the next
    level.  `leaves` holds the 2^stages final INV blocks, (2^stages, rt,
    ct, s, s), multi-tile leaves reassembled at execution.
    """
    mvm2: List[TileGrid]
    mvm3: List[TileGrid]
    leaves: TileGrid
    scale: torch.Tensor
    stages: int


def build_dist_plan(a, generator: torch.Generator, cfg: AnalogConfig,
                    stages: int, device="cuda") -> DistPlan:
    """Partition, pre-process and 'program' A level by level on `device`.

    All blocks of one level are mapped in one `map_tiled_vec` call (the
    draw order is in the module docstring).  The Schur complement of each
    block uses `block_inv` at the array size.
    """
    a = torch.as_tensor(a, device=resolve_device(device))
    s = cfg.array_size
    scale = 1.0 / torch.max(torch.abs(a))
    mvm2, mvm3 = [], []
    blocks = [a]
    for _ in range(stages):
        m = blocks[0].shape[0] // 2
        mvm2.append(map_tiled_vec(torch.stack([b[:m, m:] for b in blocks]),
                                  generator, cfg, scale))
        mvm3.append(map_tiled_vec(torch.stack([b[m:, :m] for b in blocks]),
                                  generator, cfg, scale))
        next_blocks = []
        for blk in blocks:
            b1, b2 = blk[:m, :m], blk[:m, m:]
            b3, b4 = blk[m:, :m], blk[m:, m:]
            s4 = b4 - b3 @ (block_inv(b1, s) @ b2)
            next_blocks.extend([b1, s4])
        blocks = next_blocks
    leaves = map_tiled_vec(torch.stack(blocks), generator, cfg, scale)
    return DistPlan(mvm2, mvm3, leaves, scale, stages)


def dist_execute(plan: DistPlan, b: torch.Tensor, cfg: AnalogConfig,
                 mesh=None) -> torch.Tensor:
    """Run the cascade on an (n,) rhs; the five-step signs of
    `blockamc._exec_inv`.

    Every stack of the plan is read out once per call (drift and wire
    model, one call per stack) and the cascade indexes the readouts; the
    reference reads a block's arrays each time the cascade visits it,
    which computes the same operators.  `mesh` splits every MVM of the
    cascade as `mvm_tiled_vec` does.
    """
    a2 = [g.a_eff(cfg) for g in plan.mvm2]
    a3 = [g.a_eff(cfg) for g in plan.mvm3]
    leaves = plan.leaves.a_eff(cfg)          # (2^stages, rt, ct, s, s)

    def exec_inv(level: int, idx: int, v: torch.Tensor) -> torch.Tensor:
        if level == plan.stages:
            rt, ct, s, _ = leaves.shape[1:]
            # reassemble a multi-tile leaf into the single INV operand
            a_full = leaves[idx].transpose(1, 2).reshape(rt * s, ct * s)
            return -torch.linalg.solve_ex(a_full, v).result
        m = v.shape[0] // 2
        f, g = v[:m], v[m:]
        neg_yt = exec_inv(level + 1, 2 * idx, f)                 # step 1
        gt = _mvm_tiles(a3[level][idx], neg_yt, mesh)            # step 2
        z = exec_inv(level + 1, 2 * idx + 1, -g + gt)            # step 3
        neg_ft = _mvm_tiles(a2[level][idx], z, mesh)             # step 4
        neg_y = exec_inv(level + 1, 2 * idx, f + neg_ft)         # step 5
        return torch.cat([neg_y, -z])

    return -plan.scale * exec_inv(0, 0, b)


def solve_distributed(a, b, generator: torch.Generator, cfg: AnalogConfig,
                      stages: int, mesh=None,
                      device="cuda") -> torch.Tensor:
    """Build the tile-solver plan for A on `device` and solve A x = b,
    the MVMs split over `mesh` when one is given."""
    plan = build_dist_plan(a, generator, cfg, stages, device)
    b = torch.as_tensor(b, device=plan.scale.device)
    return dist_execute(plan, b, cfg, mesh)
