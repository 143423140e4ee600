"""The vectorised tile solver of the paper's Fig. 3/5, as in
`repro/core/distributed.py`.

The two-stage BlockAMC architecture - many fixed-size arrays on a data bus,
partial MVMs recovered by summation, INV results cascaded - is written over
(rt, ct, s, s) tile tensors rather than Python tile lists, and the digital
Schur pre-processing as recursive block inversion: GEMMs and leaf-size
inverses only.  The Schur products stay plain `torch` matmuls, as the
reference leaves them to XLA.

Mesh: the reference lowers A split over a ("data", "model") TPU mesh and
lets GSPMD shard the pre-processing's GEMMs and insert the bus traffic.
Here `mesh` is a `torch.distributed` DeviceMesh with those axis names
(other axes, such as "pod", hold copies), and each rank does its share:

- the digital pre-processing holds every matrix split cyclically (`_Cyc`:
  rank (i, j) of the (p, q) ("data", "model") grid holds rows i::p and
  columns j::q), so a quadrant or a concatenation of quadrants is a local
  slice or concatenation, and each product is a local GEMM of this rank's
  output block (the row panel of the left factor gathered over "model",
  the column panel of the right one over "data": 1/(p q) of the FLOPs a
  rank).  Leaf-size inverses are gathered whole and inverted on every
  rank, as the reference's are.  A laid out in contiguous blocks (a
  `DTensor` split over ("data", "model"), the reference's
  `in_shardings`) is dealt into the cyclic split by one all-to-all a mesh
  axis; a plain A, whole on every rank, is sliced;
- each rank programs and reads out only its own tiles of every stack: of
  an (rt, ct) tile grid, tile rows `_part(rt, "data")` and tile columns
  `_part(ct, "model")`, dealt out of the cyclic split by an all-to-all;
- the cascade's MVMs run on those tiles: each rank's partial products
  are summed over "model" (all-reduce) and the row blocks gathered over
  "data" (all-gather), since the next step needs the whole vector; the
  leaves' readouts are gathered whole for their solves.

With mesh=None the same code runs with one rank on each axis: nothing is
split and nothing is sent.

Random draws: `build_dist_plan` draws one seed a stack from `generator`,
level by level - at level k the A2 stack of all 2^k blocks, then their A3
stack - and then the leaves' stack of 2^stages blocks; every tile of a
stack draws from its own generator, seeded from the stack's seed and the
tile's index in the stack ((block * rt + row) * ct + column), its
positive array's noise, then its negative array's
(`nonideal.device_draws` order).  So a rank draws its own tiles only, and
a plan built over a mesh holds the tiles of the unsharded plan drawn from
the same generator.  This replaces the reference's per-level
`jax.random.split`s, so the two packages draw different noise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

import torch
import torch.distributed as dist

from repro_torch.core import nonideal
from repro_torch.core.analog import (  # noqa: F401 (re-exported, as
    AnalogConfig, TileGrid, map_tiled_vec)  # the reference's module does)
from repro_torch.device import resolve_device
from repro_torch.sharding.api import is_dtensor, lay_out, whole


def _mvm_tiles(a_eff: torch.Tensor, v: torch.Tensor, mesh=None,
               own: bool = False) -> torch.Tensor:
    """-A_eff @ v over an (rt, ct, s, s) effective tile tensor: per-tile
    partial products summed along each tile row; with a mesh, split over
    its ("data", "model") axes (module docstring).  `own`: a_eff holds
    only this rank's tiles of a square grid (a plan built on the mesh)."""
    s = a_eff.shape[-1]
    ct = v.shape[0] // s
    rt = ct if own else a_eff.shape[0]
    vt = v.reshape(ct, s)
    if mesh is None:
        return -torch.einsum("rcij,cj->ri", a_eff, vt).reshape(rt * s)
    cols = _part(ct, mesh, "model")
    if not own:
        a_eff = a_eff[_part(rt, mesh, "data"), cols]
    out = -torch.einsum("rcij,cj->ri", a_eff, vt[cols])
    dist.all_reduce(out, group=mesh.get_group("model"))
    return _gather_parts(out, rt, mesh, "data", 0).reshape(rt * s)


def _tile_slice(n: int, size: int, idx: int) -> slice:
    """Rank idx of size's contiguous part of n tiles (the first n % size
    ranks take one more, as `torch.tensor_split`)."""
    per, extra = divmod(n, size)
    lo = idx * per + min(idx, extra)
    return slice(lo, lo + per + (idx < extra))


def _axis(mesh, axis: str):
    """(size, this rank's index) of a mesh axis; (1, 0) without a mesh."""
    if mesh is None:
        return 1, 0
    return (mesh.shape[mesh.mesh_dim_names.index(axis)],
            mesh.get_local_rank(axis))


def _part(n: int, mesh, axis: str) -> slice:
    """This rank's part of n tiles along a mesh axis."""
    return _tile_slice(n, *_axis(mesh, axis))


def _gather_parts(out: torch.Tensor, n: int, mesh, axis: str,
                  dim: int) -> torch.Tensor:
    """Dim `dim` of n entries from every `axis` rank's contiguous part
    (`_tile_slice`): parts padded to the longest, gathered in rank order
    and trimmed."""
    size, _ = _axis(mesh, axis)
    if size == 1:
        return out
    x = out.movedim(dim, 0)
    pad = x.new_zeros((-(-n // size),) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in range(size)]
    dist.all_gather(parts, pad, group=mesh.get_group(axis))
    lengths = [sl.stop - sl.start
               for sl in (_tile_slice(n, size, i) for i in range(size))]
    return torch.cat([p[:k] for p, k in zip(parts, lengths)]).movedim(0, dim)


def mvm_tiled_vec(grid: TileGrid, v: torch.Tensor, cfg: AnalogConfig,
                  mesh=None) -> torch.Tensor:
    """Partitioned analog MVM: out = -A_eff @ v with per-tile partial sums
    (the 'recover the final solution' step of refs [13]-[15]); `grid` is
    (rt, ct, s, s), `v` an (ct * s,) vector.  With a ("data", "model")
    mesh the partial products are split over its ranks and the partials
    summed over "model" (module docstring)."""
    return _mvm_tiles(grid.a_eff(cfg), v, mesh)


# ---------------------------------------------------------------------------
# A matrix split cyclically over ("data", "model")
# ---------------------------------------------------------------------------

def _count(lo: int, hi: int, first: int, p: int) -> int:
    """How many rows r in [lo, hi) have r = first (mod p)."""
    start = lo + (first - lo) % p
    return max(0, -(-(hi - start) // p))


def _exchange(x: torch.Tensor, send: List[int], recv: List[int], group
              ) -> torch.Tensor:
    """One all-to-all along dim 0: x's rows in blocks of `send[d]` for
    rank d, back `recv[s]` rows from rank s, in rank order."""
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), recv, send, group=group)
    return out


def _deal(block: torch.Tensor, dim: int, ranges: List[slice], mesh,
          axis: str) -> torch.Tensor:
    """This rank's cyclic rows (i::p) along `dim` from contiguous blocks:
    rank r of `axis` holds the rows ranges[r] (natural order)."""
    p, me = _axis(mesh, axis)
    if p == 1:
        return block
    x = block.movedim(dim, 0)
    lo, hi = ranges[me].start, ranges[me].stop
    send = [_count(lo, hi, d, p) for d in range(p)]
    x = torch.cat([x[(d - lo) % p::p] for d in range(p)])
    recv = [_count(r.start, r.stop, me, p) for r in ranges]
    return _exchange(x, send, recv, mesh.get_group(axis)).movedim(0, dim)


def _collect(local: torch.Tensor, dim: int, ranges: List[slice], mesh,
             axis: str) -> torch.Tensor:
    """The rows ranges[me] (natural order) along `dim` from their cyclic
    split (rank r of `axis` holds rows r::p)."""
    p, me = _axis(mesh, axis)
    if p == 1:
        return local.narrow(dim, ranges[0].start,
                            ranges[0].stop - ranges[0].start)
    x = local.movedim(dim, 0)

    def span(lo, hi, src):        # src's local indices of rows in [lo, hi)
        k0 = max(0, -(-(lo - src) // p))
        return k0, k0 + _count(lo, hi, src, p)
    spans = [span(r.start, r.stop, me) for r in ranges]
    x = torch.cat([x[k0:k1] for k0, k1 in spans])
    lo, hi = ranges[me].start, ranges[me].stop
    got = _exchange(x, [k1 - k0 for k0, k1 in spans],
                    [_count(lo, hi, s, p) for s in range(p)],
                    mesh.get_group(axis))
    rows = [r for s in range(p) for r in range(lo + (s - lo) % p, hi, p)]
    if rows != list(range(lo, hi)):
        order = sorted(range(len(rows)), key=rows.__getitem__)
        got = got[torch.tensor(order, device=got.device)]
    return got.movedim(0, dim)


def _unsplit(local: torch.Tensor, dim: int, n: int, mesh,
             axis: str) -> torch.Tensor:
    """All n rows along `dim` (natural order) from the cyclic split over
    `axis`: each rank's rows padded to the longest and gathered."""
    p, _ = _axis(mesh, axis)
    if p == 1:
        return local
    x = local.movedim(dim, 0)
    longest = -(-n // p)
    pad = x.new_zeros((longest,) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in range(p)]
    dist.all_gather(parts, pad, group=mesh.get_group(axis))
    # row k p + s is rank s's k-th: interleave, then drop the padding
    out = torch.stack(parts, dim=1).reshape((longest * p,)
                                            + tuple(x.shape[1:]))
    return out[:n].movedim(0, dim)


@dataclasses.dataclass
class _Cyc:
    """An (R, C) matrix split cyclically over the mesh's ("data",
    "model") axes: this rank (i, j) holds `local` = rows i::p, columns
    j::q (module docstring).  mesh=None: one rank, `local` is the
    matrix."""
    local: torch.Tensor
    shape: tuple
    mesh: Any = None

    def like(self, local: torch.Tensor, shape=None) -> "_Cyc":
        return _Cyc(local, tuple(shape or self.shape), self.mesh)

    def of_whole(self, x: torch.Tensor) -> "_Cyc":
        """This rank's cyclic part of a matrix whole on every rank."""
        (p, i), (q, j) = (_axis(self.mesh, a) for a in ("data", "model"))
        return self.like(x[i::p, j::q], x.shape)

    def whole(self) -> torch.Tensor:
        r, c = self.shape
        return _unsplit(_unsplit(self.local, 0, r, self.mesh, "data"), 1, c,
                        self.mesh, "model")

    def splits_at(self, m: int) -> bool:
        """Whether the quadrants at m are local blocks (m a multiple of
        both axes' sizes)."""
        return all(m % _axis(self.mesh, a)[0] == 0 for a in ("data", "model"))

    def block(self, rows: slice, cols: slice) -> "_Cyc":
        """Rows and columns [lo, hi): a local slice where the bounds are
        multiples of the axes' sizes (or the ends), else gathered whole
        and split again."""
        (p, _), (q, _) = (_axis(self.mesh, a) for a in ("data", "model"))
        (r, c), local = self.shape, []
        for sl, n, k in ((rows, r, p), (cols, c, q)):
            lo, hi, _ = sl.indices(n)
            if lo % k or (hi < n and hi % k):
                return self.of_whole(self.whole()[rows, cols])
            local.append(slice(lo // k, hi // k if hi < n else None))
        return self.like(self.local[tuple(local)],
                         (len(range(*rows.indices(r))),
                          len(range(*cols.indices(c)))))

    def own_tiles(self, s: int) -> torch.Tensor:
        """This rank's tiles (tile rows `_part(R / s, "data")`, columns
        `_part(C / s, "model")`) as (rt, ct, s, s)."""
        (p, _), (q, _) = (_axis(self.mesh, a) for a in ("data", "model"))
        r, c = self.shape
        rows = [_span(_tile_slice(r // s, p, k), s) for k in range(p)]
        cols = [_span(_tile_slice(c // s, q, k), s) for k in range(q)]
        x = _collect(self.local, 0, rows, self.mesh, "data")
        x = _collect(x, 1, cols, self.mesh, "model")
        return x.reshape(x.shape[0] // s, s, x.shape[1] // s,
                         s).transpose(1, 2)


def _span(tiles: slice, s: int) -> slice:
    return slice(tiles.start * s, tiles.stop * s)


def _cat(parts, dim: int) -> _Cyc:
    """Quadrants side by side (dim 1) or stacked (dim 0), each split at a
    multiple of the axes' sizes, so the local blocks concatenate."""
    shape = list(parts[0].shape)
    shape[dim] = sum(x.shape[dim] for x in parts)
    return parts[0].like(torch.cat([x.local for x in parts], dim=dim), shape)


def _mm(x: _Cyc, y: _Cyc) -> _Cyc:
    """x @ y, this rank's output block by one local GEMM: x's row panel
    gathered over "model", y's column panel over "data"."""
    k = x.shape[1]
    rows = _unsplit(x.local, 1, k, x.mesh, "model")
    cols = _unsplit(y.local, 0, k, x.mesh, "data")
    return x.like(rows @ cols, (x.shape[0], y.shape[1]))


def _sub(x: _Cyc, y: _Cyc) -> _Cyc:
    return x.like(x.local - y.local)


def _split_matrix(a, mesh, dev) -> _Cyc:
    """A as this rank's cyclic part: a DTensor (laid out over ("data",
    "model") in contiguous blocks, the reference's `in_shardings`) dealt
    by one all-to-all an axis; a plain tensor, whole on every rank,
    sliced."""
    if not is_dtensor(a):
        a = torch.as_tensor(a, device=dev)
        return _Cyc(a, tuple(a.shape), mesh).of_whole(a)
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    a = lay_out(a, a.device_mesh, [
        Shard(0) if name == "data" else Shard(1) if name == "model"
        else Replicate() for name in names])
    n, c = a.shape
    x = a.to_local()
    for dim, axis, size in ((0, "data", n), (1, "model", c)):
        p, _ = _axis(mesh, axis)
        per = -(-size // p)            # DTensor's split: torch.chunk's
        ranges = [slice(min(k * per, size), min((k + 1) * per, size))
                  for k in range(p)]
        x = _deal(x, dim, ranges, mesh, axis)
    return _Cyc(x, (n, c), mesh)


def _max_abs(x: _Cyc) -> torch.Tensor:
    top = torch.max(torch.abs(x.local))
    if x.mesh is not None:
        for axis in ("data", "model"):
            dist.all_reduce(top, op=dist.ReduceOp.MAX,
                            group=x.mesh.get_group(axis))
    return top


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
    return _block_inv(_Cyc(a, tuple(a.shape)), leaf).local


def _block_inv(x: _Cyc, leaf: int) -> _Cyc:
    """`block_inv` of a cyclically split matrix: products on local blocks
    (`_mm`); a leaf, or a block whose halves do not split evenly, gathered
    whole and inverted on every rank."""
    n = x.shape[0]
    m = n // 2
    if n <= leaf or not x.splits_at(m):
        if x.mesh is None:
            return x.like(torch.linalg.inv_ex(x.local).inverse)
        return x.of_whole(_block_inv(_Cyc(x.whole(), x.shape), leaf).local)
    a1, a2 = x.block(slice(0, m), slice(0, m)), x.block(slice(0, m),
                                                        slice(m, None))
    a3, a4 = x.block(slice(m, None), slice(0, m)), x.block(slice(m, None),
                                                           slice(m, None))
    a1i = _block_inv(a1, leaf)
    w = _mm(a1i, a2)
    v = _mm(a3, a1i)
    s = _sub(a4, _mm(a3, w))
    si = _block_inv(s, leaf)
    siv = _mm(si, v)
    top = _cat([a1i.like(a1i.local + _mm(w, siv).local),
                a1i.like(-_mm(w, si).local, (m, n - m))], 1)
    bot = _cat([siv.like(-siv.local), si], 1)
    return _cat([top, bot], 0)


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
    ct, s, s), multi-tile leaves reassembled at execution.  A plan built
    on a `mesh` holds only this rank's tiles of each grid (the module
    docstring's `_part`s).
    """
    mvm2: List[TileGrid]
    mvm3: List[TileGrid]
    leaves: TileGrid
    scale: torch.Tensor
    stages: int
    mesh: Any = None


_MASK = (1 << 64) - 1


def _tile_seed(seed: int, index: int) -> int:
    """A tile's generator seed from its stack's seed and its index
    (splitmix64's finaliser, cut to 63 bits)."""
    z = (seed + (index + 1) * 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) >> 1


def _stack_seed(generator: torch.Generator) -> int:
    """One seed drawn from `generator` (read on the host; a dry run's
    fake tensors are set aside for the draw, which holds no shape)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return int(torch.randint(0, 2 ** 62, (), generator=generator,
                                 device=generator.device))


def _program(blocks: List[_Cyc], generator: torch.Generator,
             cfg: AnalogConfig, scale: torch.Tensor) -> TileGrid:
    """This rank's tiles of a stack of blocks, programmed: the targets
    write-verified together (`nonideal.write_verified`), then each tile's
    noise from its own generator (module docstring)."""
    seed = _stack_seed(generator)
    s = cfg.array_size
    rows, cols = blocks[0].shape
    if rows % s or cols % s:
        raise ValueError(f"the tile solver needs multiples of the array "
                         f"size {s}, got {(rows, cols)}")
    rt, ct = rows // s, cols // s
    tiles = torch.stack([b.own_tiles(s) for b in blocks])
    a_norm = tiles * scale
    targets = torch.stack([torch.clamp_min(a_norm, 0.0) * cfg.g0,
                           torch.clamp_min(-a_norm, 0.0) * cfg.g0])
    ni = cfg.nonideal
    written = nonideal.write_verified(targets, ni)
    draws = [[None, None], [None, None]]     # [sign][normal, uniform]
    if ni.sigma != 0.0 or nonideal._has_faults(ni):
        mesh = blocks[0].mesh
        r_own, c_own = _part(rt, mesh, "data"), _part(ct, mesh, "model")
        got = [[[], []], [[], []]]
        for blk in range(len(blocks)):
            for r in range(r_own.start, r_own.stop):
                for c in range(c_own.start, c_own.stop):
                    gen = torch.Generator(device=generator.device)
                    gen.manual_seed(_tile_seed(seed, (blk * rt + r) * ct + c))
                    for sign in range(2):
                        for kind, d in enumerate(nonideal.device_draws(
                                (s, s), gen, ni, targets.dtype)):
                            got[sign][kind].append(d)
        draws = [[torch.stack(d).reshape(tiles.shape)   # none: no tiles
                  if d and d[0] is not None else None for d in sign]
                 for sign in got]
    g = [nonideal.apply_device_draws(written[i], targets[i], *draws[i], ni,
                                     cfg.g0)
         for i in range(2)]                       # positive, negative
    return TileGrid(g[0], g[1], scale, cfg.g0)


def build_dist_plan(a, generator: torch.Generator, cfg: AnalogConfig,
                    stages: int, device="cuda", mesh=None) -> DistPlan:
    """Partition, pre-process and 'program' A level by level on `device`.

    With a ("data", "model") `mesh` (a DTensor A's own by default), A may
    be a DTensor laid out over it (or whole on every rank); the
    pre-processing runs on each rank's share and each rank programs its
    own tiles (module docstring; the draw order too).  The Schur
    complement of each block uses the block inversion at the array
    size.
    """
    dev = resolve_device(device)
    s = cfg.array_size
    if mesh is None and is_dtensor(a):
        mesh = a.device_mesh
    x = _split_matrix(a, mesh, dev)
    scale = 1.0 / _max_abs(x)
    mvm2, mvm3 = [], []
    blocks = [x]
    for _ in range(stages):
        m = blocks[0].shape[0] // 2
        top, rest = slice(0, m), slice(m, None)
        mvm2.append(_program([b.block(top, rest) for b in blocks], generator,
                             cfg, scale))
        mvm3.append(_program([b.block(rest, top) for b in blocks], generator,
                             cfg, scale))
        next_blocks = []
        for blk in blocks:
            b1, b2 = blk.block(top, top), blk.block(top, rest)
            b3, b4 = blk.block(rest, top), blk.block(rest, rest)
            s4 = _sub(b4, _mm(b3, _mm(_block_inv(b1, s), b2)))
            next_blocks.extend([b1, s4])
        blocks = next_blocks
    leaves = _program(blocks, generator, cfg, scale)
    return DistPlan(mvm2, mvm3, leaves, scale, stages, mesh)


def dist_execute(plan: DistPlan, b: torch.Tensor, cfg: AnalogConfig,
                 mesh=None) -> torch.Tensor:
    """Run the cascade on an (n,) rhs; the five-step signs of
    `blockamc._exec_inv`.

    Every stack of the plan is read out once per call (drift and wire
    model, one call per stack) and the cascade indexes the readouts; the
    reference reads a block's arrays each time the cascade visits it,
    which computes the same operators.  `mesh` splits every MVM of the
    cascade as `mvm_tiled_vec` does; a plan built on a mesh runs on it,
    each rank reading out its own tiles (module docstring).
    """
    own = plan.mesh is not None
    mesh = plan.mesh if own else mesh
    b = whole(b)
    a2 = [g.a_eff(cfg) for g in plan.mvm2]
    a3 = [g.a_eff(cfg) for g in plan.mvm3]
    leaves = plan.leaves.a_eff(cfg)          # (2^stages, rt, ct, s, s)
    if own:
        s = leaves.shape[-1]
        rt = b.shape[0] // 2 ** plan.stages // s
        leaves = _gather_parts(_gather_parts(leaves, rt, mesh, "data", 1),
                               rt, mesh, "model", 2)

    def exec_inv(level: int, idx: int, v: torch.Tensor) -> torch.Tensor:
        if level == plan.stages:
            rt, ct, s, _ = leaves.shape[1:]
            # reassemble a multi-tile leaf into the single INV operand
            a_full = leaves[idx].transpose(1, 2).reshape(rt * s, ct * s)
            return -torch.linalg.solve_ex(a_full, v).result
        m = v.shape[0] // 2
        f, g = v[:m], v[m:]
        neg_yt = exec_inv(level + 1, 2 * idx, f)                 # step 1
        gt = _mvm_tiles(a3[level][idx], neg_yt, mesh, own)       # step 2
        z = exec_inv(level + 1, 2 * idx + 1, -g + gt)            # step 3
        neg_ft = _mvm_tiles(a2[level][idx], z, mesh, own)        # step 4
        neg_y = exec_inv(level + 1, 2 * idx, f + neg_ft)         # step 5
        return torch.cat([neg_y, -z])

    return -plan.scale * exec_inv(0, 0, b)


def solve_distributed(a, b, generator: torch.Generator, cfg: AnalogConfig,
                      stages: int, mesh=None,
                      device="cuda") -> torch.Tensor:
    """Build the tile-solver plan for A on `device` and solve A x = b.
    With a ("data", "model") `mesh` the plan is built and executed split
    over it (A a DTensor laid out over the mesh, or whole on every rank;
    b whole or a DTensor); x is whole on every rank."""
    plan = build_dist_plan(a, generator, cfg, stages, device, mesh)
    b = torch.as_tensor(whole(b), device=plan.scale.device)
    return dist_execute(plan, b, cfg)
