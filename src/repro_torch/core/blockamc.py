"""BlockAMC: block-partitioned analog solver for A x = b (paper Section III),
as in `repro/core/blockamc.py`.

    A = [[A1, A2],      b = [f,
         [A3, A4]]           g]

Algorithm 1 runs five cascaded analog operations per stage (INV(A1),
MVM(A3), INV(A4s) on the Schur complement A4s = A4 - A3 A1^-1 A2, MVM(A2),
INV(A1)); INV steps larger than one physical array recurse.

The program-once / solve-many pipeline, in the reference's names:

  partition_system -> program_system   the recursive plan (programming)
  execute                              the recursive reference executor
  compile_plan                         flat level schedule over stacks
  finalize / execute_finalized         LU factors and fused MVM operators
  compile_arena / execute_arena        the serving form: one register arena
                                       with static slot offsets; INV buckets
                                       become explicit negated inverses and
                                       MVM tiles absorb sign and divisor, so
                                       every level is a stacked-tile matmul
  ProgrammedSolver                     the handle over all of the above
  pack_arena_plans / program_packed /  the multi-tenant form: M plans of one
  execute_arena_packed                 `plan_signature` on a leading axis
  build_original_plan / solve_original the single-array baseline ("original
                                       AMC" of the paper's comparisons)
  execute_flat                         the unfinalized level-schedule run
  solve_batched /                      Monte-Carlo drivers: one simulation
  solve_original_batched               per generator, batched on a leading
                                       axis of every conductance stack

The arena form has two executions of one layout.  The plain path runs each
level as PyTorch matmuls over the materialized registers (slot-SSA form).
The kernel path owns one physical (S, K) arena buffer per instance and
runs the hand-written CUDA kernel (`repro_torch.kernels`): a uniform plan
(`ArenaPlan.program`) as ONE launch for the whole cascade, any other
whole-window plan as one launch per (level, operator stack) group.  Plans
with ragged (multi-segment) windows stay on the plain path.

Differences from the reference, by design:

  * Random draws come from one `torch.Generator`, consumed in a fixed
    order: a stage programs inv1's subtree, then A2's tiles (row-major),
    then A3's tiles, then inv4s's subtree; each tile draws its positive
    array before its negative one (`analog.map_matrix`), and each array
    its variation normals before its stuck-at uniforms
    (`nonideal.program_conductances`).  The Monte-Carlo drivers take one
    generator per simulation, each consumed in that same order.  The
    reference splits JAX keys instead, so the two packages draw
    different noise.
  * There is no jit, vmap or pytree.  A leading instance axis is written
    out: the packed path's tenants, the Monte-Carlo drivers' simulations
    (where the reference vmaps over keys).  The packed programming
    functions loop over instances.
  * Block repair (`repair_blocks`) re-draws the named arrays' noise from
    one generator by replaying the whole programming order: it walks
    every array of the plan in the lexicographic order of its
    `BlockRecord.path` - which is the programming order above (inv1's
    subtree, A2's tiles, A3's tiles, inv4s's subtree), not the block
    map's own compile-emission order - draws each array pair's noise
    (`analog.pair_draws`; the shapes do not depend on the data, and
    write-verify draws nothing) and keeps the draws of the named arrays
    only.  So repairing every block under a generator seeded s gives
    exactly what `ProgrammedSolver.program` under seed s gives, and a
    subset gets exactly that full re-program's slices.  (The reference
    derives each array's key from its path instead, `_path_key`, which
    torch cannot replay.)
  * The differentiable cascade (`_Cascade`, the reference's `_cascade`
    custom VJP) is a `torch.autograd.Function`.  Its backward is the
    reference's reverse sweep over the same operator stacks, in plain
    torch: a rhs gradient reads no register (each tile's input adjoint is
    ops^T @ cot), so on the card the forward stays on the arena kernel;
    a stack gradient needs each tile's input window, which the kernel's
    arena does not keep (it reuses slots), so the backward recomputes the
    registers on the plain levels.  The kernel wrappers take no tensor
    that requires grad: the kernels run outside autograd.
  * Not ported yet: the sharded solve functions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import analog
from repro_torch.core.analog import (AnalogConfig, CrossbarPair, Generators,
                                     TileGrid)
from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LeafInvPlan:
    """An INV operation small enough for one physical array."""
    pair: CrossbarPair

    @property
    def n(self):
        return self.pair.shape[0]


@dataclasses.dataclass
class BlockPlan:
    """One BlockAMC stage: INV plans for A1/A4s, tiled MVM grids for A2/A3."""
    inv1: Any
    mvm2: list
    mvm3: list
    inv4s: Any
    m: int

    @property
    def n(self):
        return self.inv1.n + self.inv4s.n


Plan = Union[LeafInvPlan, BlockPlan]


@dataclasses.dataclass
class SolvePlan:
    """Top-level plan: the recursive structure plus the global scale."""
    root: Plan
    scale: torch.Tensor   # c = 1/max|A|; the solution is descaled digitally


# ---------------------------------------------------------------------------
# Plan construction (programming time)
# ---------------------------------------------------------------------------

def required_stages(n: int, array_size: int) -> int:
    """Smallest number of partitioning stages so every INV fits one array."""
    stages = 0
    while n > array_size:
        n = -(-n // 2)
        stages += 1
    return stages


@dataclasses.dataclass
class LeafTarget:
    """Partitioning leaf: one block destined for a single INV array."""
    a: torch.Tensor

    @property
    def n(self):
        return self.a.shape[0]


@dataclasses.dataclass
class BlockTarget:
    """One partitioning stage: INV targets for A1/A4s, raw blocks A2/A3."""
    inv1: Any
    a2: torch.Tensor
    a3: torch.Tensor
    inv4s: Any
    m: int

    @property
    def n(self):
        return self.inv1.n + self.inv4s.n


Target = Union[LeafTarget, BlockTarget]


@dataclasses.dataclass
class PartitionedSystem:
    """Noise-independent digital pre-processing of one system matrix."""
    root: Target
    scale: torch.Tensor   # c = 1/max|A|


def _split_tree(n: int, stages: int):
    """The static partition split tree for (n, stages): a leaf size, or a
    pair of subtrees.  A 1x1 block is not split further; for odd n, A1
    takes (n+1)/2."""
    if stages == 0 or n <= 1:
        return int(n)
    m = -(-n // 2)
    return (_split_tree(m, stages - 1), _split_tree(n - m, stages - 1))


def _tree_size(tree) -> int:
    return tree if isinstance(tree, int) else \
        _tree_size(tree[0]) + _tree_size(tree[1])


def _partition_by(a: torch.Tensor, tree) -> Target:
    if isinstance(tree, int):
        return LeafTarget(a)
    left, right = tree
    m = _tree_size(left)
    a1, a2 = a[:m, :m], a[:m, m:]
    a3, a4 = a[m:, :m], a[m:, m:]
    # digital pre-processing of the Schur complement (paper Eq. 3)
    a4s = a4 - a3 @ torch.linalg.solve(a1, a2)
    return BlockTarget(_partition_by(a1, left), a2, a3,
                       _partition_by(a4s, right), m)


def partition_system(a: torch.Tensor, cfg: AnalogConfig,
                     stages: Optional[int] = None) -> PartitionedSystem:
    """Partition, Schur-complement and normalise A (no noise drawn).

    stages=None selects the least depth so leaves fit cfg.array_size.
    """
    n = a.shape[0]
    if stages is None:
        stages = required_stages(n, cfg.array_size)
    scale = 1.0 / torch.max(torch.abs(a))
    return PartitionedSystem(root=_partition_by(a, _split_tree(n, stages)),
                             scale=scale)


def _program(t: Target, generator: Generators, cfg: AnalogConfig,
             scale: torch.Tensor, use_kernel=None) -> Plan:
    if isinstance(t, LeafTarget):
        return LeafInvPlan(analog.map_matrix(t.a, generator, cfg, scale,
                                             use_kernel))
    # the documented draw order: inv1, A2, A3, inv4s
    inv1 = _program(t.inv1, generator, cfg, scale, use_kernel)
    mvm2 = analog.map_tiled(t.a2, generator, cfg, scale, use_kernel)
    mvm3 = analog.map_tiled(t.a3, generator, cfg, scale, use_kernel)
    inv4s = _program(t.inv4s, generator, cfg, scale, use_kernel)
    return BlockPlan(inv1=inv1, mvm2=mvm2, mvm3=mvm3, inv4s=inv4s, m=t.m)


def program_system(parts: PartitionedSystem, generator: Generators,
                   cfg: AnalogConfig,
                   use_kernel: Optional[bool] = None) -> SolvePlan:
    """'Program' a partitioned system: conductance mapping + device noise.

    A sequence of generators programs one Monte-Carlo simulation each: the
    plan's pairs carry a leading simulation axis (see `analog.map_matrix`)
    and `compile_plan` stacks them to (S, num, r, c).  The recursive
    `execute` takes single plans only; `execute_flat`, `finalize` and the
    executors after it take either.  `use_kernel` picks the sweeps of
    nodal write-verify's readouts (`nonideal.wire_readout`'s convention).
    """
    return SolvePlan(root=_program(parts.root, generator, cfg, parts.scale,
                                   use_kernel),
                     scale=parts.scale)


def build_plan(a: torch.Tensor, generator: Generators,
               cfg: AnalogConfig, stages: Optional[int] = None) -> SolvePlan:
    """Partition, pre-process, normalise and 'program' matrix A."""
    return program_system(partition_system(a, cfg, stages), generator, cfg)


def build_original_plan(a: torch.Tensor, generator: Generators,
                        cfg: AnalogConfig,
                        use_kernel: Optional[bool] = None) -> SolvePlan:
    """The baseline 'original AMC': one monolithic INV array of size n,
    whatever cfg.array_size says (every paper comparison's baseline).
    `use_kernel` is `program_system`'s."""
    scale = 1.0 / torch.max(torch.abs(a))
    return SolvePlan(root=LeafInvPlan(analog.map_matrix(a, generator, cfg,
                                                        scale, use_kernel)),
                     scale=scale)


# ---------------------------------------------------------------------------
# Recursive reference executor (five-step cascade per stage)
# ---------------------------------------------------------------------------

def _exec_inv(plan: Plan, v_in: torch.Tensor,
              cfg: AnalogConfig) -> torch.Tensor:
    """Run an INV plan with the circuit sign convention: returns -A^-1 v_in."""
    if isinstance(plan, LeafInvPlan):
        return analog.amc_inv(plan.pair, v_in, cfg)
    m = plan.m
    f, g = v_in[:m], v_in[m:]
    neg_yt = _exec_inv(plan.inv1, f, cfg)                 # step 1: -y_t
    gt = analog.amc_mvm_tiled(plan.mvm3, neg_yt, cfg)     # step 2: g_t
    neg_gs = -g + gt                                      # -g_s
    z = _exec_inv(plan.inv4s, neg_gs, cfg)                # step 3: +z
    neg_ft = analog.amc_mvm_tiled(plan.mvm2, z, cfg)      # step 4: -f_t
    fs = f + neg_ft                                       # f_s = f - f_t
    neg_y = _exec_inv(plan.inv1, fs, cfg)                 # step 5: -y
    return torch.cat([neg_y, -z])


def execute(plan: SolvePlan, b: torch.Tensor,
            cfg: AnalogConfig) -> torch.Tensor:
    """Solve A x = b with the programmed plan; returns x.

    The arrays hold A' = cA, so the cascade's output is -(A^-1 b)/c and
    the host recovers x = -c * out.
    """
    out = _exec_inv(plan.root, analog.dac(b, cfg), cfg)
    return -plan.scale * analog.adc(out, cfg)


def solve(a: torch.Tensor, b: torch.Tensor, generator: torch.Generator,
          cfg: AnalogConfig, stages: Optional[int] = None) -> torch.Tensor:
    """Convenience: build_plan + execute."""
    return execute(build_plan(a, generator, cfg, stages), b, cfg)


def solve_original(a: torch.Tensor, b: torch.Tensor,
                   generator: torch.Generator,
                   cfg: AnalogConfig) -> torch.Tensor:
    """Baseline: original (monolithic) AMC solve."""
    return execute(build_original_plan(a, generator, cfg), b, cfg)


# ---------------------------------------------------------------------------
# Flat (level-scheduled) form
#
# Schedule instruction set (all operands are Python ints):
#   ("slice", src, lo, hi)        reg = regs[src][lo:hi]
#   ("inv",   bucket, idx, src)   reg = amc_inv(inv_stack[bucket][idx],
#                                               regs[src])
#   ("mvm",   rows, src)          reg = amc_mvm_tiled(grid, regs[src]); rows
#                                 is a tuple of tile-rows of (bucket, idx)
#   ("add",   s1, r1, s2, r2)     reg = s1*regs[r1] + s2*regs[r2]
#   ("catneg", r1, r2)            reg = concat([regs[r1], -regs[r2]])
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlatPlan:
    """Level-scheduled form of a SolvePlan.

    `inv_stacks` / `mvm_stacks` hold one TileGrid per (cascade depth, array
    shape) bucket; `schedule` is the static level program; `inv_keys` /
    `mvm_keys` record each bucket's (depth, shape).
    """
    inv_stacks: Tuple[TileGrid, ...]
    mvm_stacks: Tuple[TileGrid, ...]
    scale: torch.Tensor
    schedule: tuple
    n: int
    inv_keys: tuple
    mvm_keys: tuple

    @property
    def num_arrays(self) -> int:
        return sum(g.shape[-3] for g in self.inv_stacks) + \
            sum(g.shape[-3] for g in self.mvm_stacks)


class _Interner:
    """Dedupes physical arrays into (depth, shape)-bucketed stacking lists;
    a pair referenced twice (A1 serves steps 1 and 5) is stacked once."""

    def __init__(self):
        self.key_to_bucket = {}
        self.lists = []
        self.keys = []
        self._memo = {}

    def ref(self, key, pair) -> Tuple[int, int]:
        tag = id(pair)
        if tag in self._memo:
            return self._memo[tag]
        if key not in self.key_to_bucket:
            self.key_to_bucket[key] = len(self.lists)
            self.lists.append([])
            self.keys.append(key)
        bucket = self.key_to_bucket[key]
        self.lists[bucket].append(pair)
        out = (bucket, len(self.lists[bucket]) - 1)
        self._memo[tag] = out
        return out


def compile_plan(plan: SolvePlan) -> FlatPlan:
    """Lower a recursive SolvePlan to its level-scheduled flat form (pure
    restructuring: the stacked conductances are the plan's own)."""
    invs, mvms = _Interner(), _Interner()
    prog = []
    n_regs = [1]                      # register 0 is the cascade input

    def emit(instr) -> int:
        prog.append(instr)
        r = n_regs[0]
        n_regs[0] += 1
        return r

    def emit_inv(p: Plan, src: int, depth: int) -> int:
        if isinstance(p, LeafInvPlan):
            bucket, idx = invs.ref((depth, p.pair.shape), p.pair)
            return emit(("inv", bucket, idx, src))
        m, n = p.m, p.n
        f = emit(("slice", src, 0, m))
        g = emit(("slice", src, m, n))
        neg_yt = emit_inv(p.inv1, f, depth + 1)                  # step 1
        rows3 = tuple(tuple(mvms.ref((depth, t.shape), t) for t in row)
                      for row in p.mvm3)
        gt = emit(("mvm", rows3, neg_yt))                        # step 2
        neg_gs = emit(("add", -1, g, 1, gt))
        z = emit_inv(p.inv4s, neg_gs, depth + 1)                 # step 3
        rows2 = tuple(tuple(mvms.ref((depth, t.shape), t) for t in row)
                      for row in p.mvm2)
        neg_ft = emit(("mvm", rows2, z))                         # step 4
        fs = emit(("add", 1, f, 1, neg_ft))
        neg_y = emit_inv(p.inv1, fs, depth + 1)                  # step 5
        return emit(("catneg", neg_y, z))

    emit_inv(plan.root, 0, 0)
    g0 = _first_pair(plan.root).g0
    inv_stacks = tuple(analog.stack_pairs(ps, plan.scale, g0)
                       for ps in invs.lists)
    mvm_stacks = tuple(analog.stack_pairs(ps, plan.scale, g0)
                       for ps in mvms.lists)
    return FlatPlan(inv_stacks, mvm_stacks, plan.scale, tuple(prog),
                    plan.root.n, tuple(invs.keys), tuple(mvms.keys))


def _first_pair(p: Plan) -> CrossbarPair:
    return p.pair if isinstance(p, LeafInvPlan) else _first_pair(p.inv1)


def build_flat_plan(a: torch.Tensor, generator: Generators,
                    cfg: AnalogConfig,
                    stages: Optional[int] = None) -> FlatPlan:
    """Convenience: build_plan + compile_plan."""
    return compile_plan(build_plan(a, generator, cfg, stages))


def _inv_operators(grid: TileGrid, cfg: AnalogConfig, r_wire=None,
                   drift_t=None, use_kernel=None) -> torch.Tensor:
    """The (..., num, s, s) matrices one INV bucket's circuits solve with:
    the effective conductance plus the finite-gain diagonal loading."""
    a = grid.a_eff(cfg, r_wire=r_wire, drift_t=drift_t,
                   use_kernel=use_kernel)
    if cfg.opa_gain is not None:
        load = (cfg.g0 + torch.sum(grid.gpos + grid.gneg, dim=-1)) \
            / (cfg.opa_gain * cfg.g0)
        a = a + load[..., :, None] * torch.eye(a.shape[-1], dtype=a.dtype,
                                               device=a.device)
    return a


# ---------------------------------------------------------------------------
# Finalization: program-once / solve-many
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _MvmLevel:
    """One finalized tiled-MVM schedule level.

    `stacks[g]` holds the effective operators of all same-shape tiles as an
    (L, rows, cols) tensor; `windows[g]` their input windows; `rows` lists,
    per output tile-row, the (group, index) tile refs in column order;
    `divs` the per-tile-row finite-gain divisors (empty for an ideal OPA).
    """
    stacks: tuple
    divs: tuple
    windows: tuple
    rows: tuple

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """v (..., cols, k) -> (..., rows, k), accumulating in
        `amc_mvm_tiled`'s per-row order; leading axes are a Monte-Carlo
        batch of the plan."""
        divs = self.divs if self.divs else (None,) * len(self.rows)
        outs = []
        for refs, div in zip(self.rows, divs):
            acc = None
            for g, i in refs:
                lo, hi = self.windows[g][i]
                p = -(self.stacks[g][..., i, :, :] @ v[..., lo:hi, :])
                acc = p if acc is None else acc + p
            if div is not None:
                acc = acc / div[..., None]
            outs.append(acc)
        return torch.cat(outs, dim=-2)


@dataclasses.dataclass
class FinalizedPlan:
    """A FlatPlan finalized against one AnalogConfig: per-bucket LU factors
    (`lu_stacks`, (LU, pivots) pairs), fused MVM levels, and the schedule
    with every "mvm" rewritten to ("fmvm", level, src)."""
    lu_stacks: tuple
    mvm_levels: tuple
    scale: torch.Tensor
    schedule: tuple
    n: int
    cfg: AnalogConfig
    num_arrays: int


def _finalize_mvm_level(fplan: FlatPlan, rows, cfg: AnalogConfig,
                        mvm_eff) -> _MvmLevel:
    """Gather one "mvm" level's effective operators (from `mvm_eff`, the
    per-bucket readouts) and precompute its divisors."""
    groups: dict = {}        # (r, c) tile shape -> group index
    stacks: list = []
    windows: list = []
    row_refs = []
    divs = []
    for row in rows:
        col_off = 0
        refs = []
        load = cfg.g0
        for bk, i in row:
            pair = fplan.mvm_stacks[bk].tile(i)
            r, c = pair.shape
            if (r, c) not in groups:
                groups[(r, c)] = len(stacks)
                stacks.append([])
                windows.append([])
            g = groups[(r, c)]
            refs.append((g, len(stacks[g])))
            stacks[g].append(mvm_eff[bk][..., i, :, :])
            windows[g].append((col_off, col_off + c))
            load = load + torch.sum(pair.gpos + pair.gneg, dim=-1)
            col_off += c
        row_refs.append(tuple(refs))
        if cfg.opa_gain is not None:
            divs.append(1.0 + load / (cfg.opa_gain * cfg.g0))
    return _MvmLevel(tuple(torch.stack(s, dim=-3) for s in stacks),
                     tuple(divs), tuple(tuple(w) for w in windows),
                     tuple(row_refs))


@dataclasses.dataclass(frozen=True)
class PlanAges:
    """Per-physical-array device ages of one FlatPlan (simulated clock).

    `inv[b]` / `mvm[b]` is bucket b's age: a scalar, or a (num,) vector
    giving each array of the bucket its own age.  Ages are in the drift
    model's t0 = 1 s units; like the `r_wire` override they are array
    contents and never enter `plan_signature`.
    """
    inv: tuple
    mvm: tuple


def uniform_ages(fplan: FlatPlan, t) -> PlanAges:
    """PlanAges giving every array of `fplan` the same age `t`."""
    dev = fplan.scale.device

    def ages(stacks):
        return tuple(torch.full((g.shape[-3],), float(t),
                                dtype=torch.float32, device=dev)
                     for g in stacks)
    return PlanAges(ages(fplan.inv_stacks), ages(fplan.mvm_stacks))


def _split_ages(fplan: FlatPlan, drift_t):
    """Normalise a finalize `drift_t` argument to per-bucket age tuples."""
    if drift_t is None:
        return None, None
    if isinstance(drift_t, PlanAges):
        return drift_t.inv, drift_t.mvm
    return ((drift_t,) * len(fplan.inv_stacks),
            (drift_t,) * len(fplan.mvm_stacks))


def _ages_at(ages, b, sel=None):
    """Bucket b's age (None when no ages were given), restricted to the
    arrays `sel` when it is a vector."""
    if ages is None:
        return None
    age = ages[b]
    vec = torch.as_tensor(age)
    if sel is None or vec.ndim == 0:
        return age
    return vec[sel.to(vec.device)]


def _lu_factor(ops: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(LU, 1-based pivots) of a stack of operators, singular ones
    included: a stuck-at fault can zero a pivot, and the reference's
    `lu_factor` then factors on (its solves turn non-finite, which the
    serving canary catches) where `torch.linalg.lu_factor` raises.  No
    host read of the error code either, so the card is not stalled."""
    lu, piv, _ = torch.linalg.lu_factor_ex(ops)
    return lu, piv


def finalize(fplan: FlatPlan, cfg: AnalogConfig, r_wire=None,
             drift_t=None, use_kernel: Optional[bool] = None
             ) -> FinalizedPlan:
    """Precompute all per-solve-invariant operators of a flat plan.

    Every bucket of arrays is read out once, as one stack: one call of the
    wire model per INV and per MVM bucket (one batched nodal readout each
    under `wire_model="nodal"`).  The plan's stacks may carry a leading
    Monte-Carlo axis (`program_system` with a sequence of generators); the
    finalized operators then carry it too.  `r_wire` optionally overrides
    the config wire resistance (first-order model; differentiable, the
    calibration hook of `repro_torch.calib`).  `drift_t` optionally
    overrides the config device age: a scalar ages the whole plan, a
    `PlanAges` each array on its own (a bucket's (num,) vector lines up
    with the stack's array axis, behind any Monte-Carlo axis).
    `use_kernel=False` runs the nodal readouts' sweeps in their plain
    version on the card (None: the kernel for CUDA tensors).
    """
    inv_ages, mvm_ages = _split_ages(fplan, drift_t)
    lu_stacks = tuple(
        _lu_factor(_inv_operators(g, cfg, r_wire=r_wire,
                                  drift_t=_ages_at(inv_ages, b),
                                  use_kernel=use_kernel))
        for b, g in enumerate(fplan.inv_stacks))
    mvm_eff = tuple(g.a_eff(cfg, r_wire=r_wire,
                            drift_t=_ages_at(mvm_ages, b),
                            use_kernel=use_kernel)
                    for b, g in enumerate(fplan.mvm_stacks))
    mvm_levels = []
    schedule = []
    for instr in fplan.schedule:
        if instr[0] == "mvm":
            _, rows, src = instr
            schedule.append(("fmvm", len(mvm_levels), src))
            mvm_levels.append(_finalize_mvm_level(fplan, rows, cfg,
                                                  mvm_eff))
        else:
            schedule.append(instr)
    return FinalizedPlan(lu_stacks, tuple(mvm_levels), fplan.scale,
                         tuple(schedule), fplan.n, cfg, fplan.num_arrays)


def execute_finalized(fin: FinalizedPlan, b: torch.Tensor) -> torch.Tensor:
    """Run a finalized schedule; returns x like `execute`.  `b` may be (n,)
    or (n, k); a plan with a leading Monte-Carlo axis S answers (S, n) or
    (S, n, k).  Registers are (..., rows, k) throughout."""
    cfg = fin.cfg
    single = b.ndim == 1
    bk = b[:, None] if single else b
    lead = (fin.lu_stacks[0][0] if fin.lu_stacks
            else fin.mvm_levels[0].stacks[0]).shape[:-3]
    regs = [analog.dac(bk, cfg).expand(lead + tuple(bk.shape))]
    for instr in fin.schedule:
        op = instr[0]
        if op == "slice":
            _, src, lo, hi = instr
            regs.append(regs[src][..., lo:hi, :])
        elif op == "inv":
            _, bucket, idx, src = instr
            lu, piv = fin.lu_stacks[bucket]
            regs.append(-torch.linalg.lu_solve(lu[..., idx, :, :],
                                               piv[..., idx, :], regs[src]))
        elif op == "fmvm":
            _, level, src = instr
            regs.append(fin.mvm_levels[level].apply(regs[src]))
        elif op == "add":
            _, s1, r1, s2, r2 = instr
            x1 = regs[r1] if s1 > 0 else -regs[r1]
            x2 = regs[r2] if s2 > 0 else -regs[r2]
            regs.append(x1 + x2)
        elif op == "catneg":
            _, r1, r2 = instr
            regs.append(torch.cat([regs[r1], -regs[r2]], dim=-2))
        else:  # pragma: no cover - finalize only emits the ops above
            raise ValueError(f"unknown schedule op {op!r}")
    out = regs[-1][..., 0] if single else regs[-1]
    return -fin.scale * analog.adc(out, cfg)


def execute_flat(fplan: FlatPlan, b: torch.Tensor, cfg: AnalogConfig,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Run the level schedule straight from the conductances; returns x
    like `execute`.  The unfinalized reference: every INV bucket is read
    out and factorised once per call and every MVM tile re-derived, in the
    order the reference's `execute_flat` uses, so it is `finalize`
    followed by `execute_finalized`.  A plan with a leading Monte-Carlo
    axis S answers (S, n) or (S, n, k).  `use_kernel` is `finalize`'s."""
    return execute_finalized(finalize(fplan, cfg, use_kernel=use_kernel), b)


# ---------------------------------------------------------------------------
# Arena executor
#
# Static metadata vocabulary (every number a Python int):
#   term     (mreg, local_off, sign)       one signed window read
#   segment  (dst_lo, seg_len, terms)      one contiguous chunk of an operand
#   tile     (stack_id, idx, m_out, init_  one operator application, in
#             row_off, init, segs)         schedule order; init=True starts
#                                          its output row, False adds to it
#   level    tuple of tiles                one schedule compute level
# A materialized register m lives at arena offset slot_offsets[m].
# ---------------------------------------------------------------------------

def _view_slice(view, lo, hi):
    out, pos = [], 0
    for chunk_len, terms in view:
        s_lo, s_hi = max(lo, pos), min(hi, pos + chunk_len)
        if s_lo < s_hi:
            d = s_lo - pos
            out.append((s_hi - s_lo,
                        tuple((m, o + d, s) for m, o, s in terms)))
        pos += chunk_len
    return tuple(out)


def _view_scale(view, sign):
    if sign > 0:
        return view
    return tuple((n_, tuple((m, o, -s) for m, o, s in terms))
                 for n_, terms in view)


def _view_add(v1, v2):
    """Refine two equal-length views to common chunk boundaries; the term
    order (all of v1's chunk terms, then v2's) replays `x1 + x2`."""
    out = []
    v1, v2 = list(v1), list(v2)
    i = j = 0
    while i < len(v1):
        l1, t1 = v1[i]
        l2, t2 = v2[j]
        step = min(l1, l2)
        out.append((step, t1 + t2))
        if l1 > step:
            v1[i] = (l1 - step, tuple((m, o + step, s) for m, o, s in t1))
        else:
            i += 1
        if l2 > step:
            v2[j] = (l2 - step, tuple((m, o + step, s) for m, o, s in t2))
        else:
            j += 1
    return tuple(out)


@dataclasses.dataclass
class ArenaPlan:
    """Arena form of a FinalizedPlan: the serving executor.

    `stacks` holds every operator as (num, rows, cols): one stack per INV
    bucket (explicit negated inverses), then one per (MVM level, tile
    shape) group (circuit sign and divisor folded in).  `program`, present
    when every tile shares one shape and reads one whole window, is the
    whole schedule as (ops (T, R, C), in_offs (T, J) int32, in_signs (T, J)
    f32, out_offs (T,) int32, out_init (T,) int32) - the form the kernel
    runs in one launch.
    """
    stacks: tuple
    scale: torch.Tensor
    program: Optional[tuple]
    levels: tuple
    out_spec: tuple
    arena_size: int
    n: int
    in_off: int
    cfg: AnalogConfig
    kernel_ok: bool
    num_arrays: int
    slot_offsets: tuple
    slot_ranges: tuple
    peak_liveness: int


def _lowest_fit(placed, length):
    """Lowest offset where `length` cells avoid every (off, len) in placed."""
    off = 0
    for lo, ln in sorted(placed):
        if off + length <= lo:
            break
        off = max(off, lo + ln)
    return off


def _allocate_slots(intervals):
    """Offline register-arena allocation over known live intervals
    {mreg: (length, def_pos, last_use)}: the smaller extent of first-fit in
    definition order and greedy-by-size."""
    def extent(offsets):
        return max(o + intervals[m][0] for m, o in offsets.items())

    def overlaps(m1, m2):
        _, d1, u1 = intervals[m1]
        _, d2, u2 = intervals[m2]
        return not (u1 < d2 or u2 < d1)

    layouts = []
    for order in (
            sorted(intervals, key=lambda m: (intervals[m][1], m)),
            sorted(intervals, key=lambda m: (-intervals[m][0],
                                             intervals[m][1], m))):
        offsets = {}
        for m in order:
            placed = [(offsets[m2], intervals[m2][0])
                      for m2 in offsets if overlaps(m, m2)]
            offsets[m] = _lowest_fit(placed, intervals[m][0])
        layouts.append(offsets)
    return min(layouts, key=extent)


def compile_arena(fin: FinalizedPlan) -> ArenaPlan:
    """Lower a FinalizedPlan to its arena form.

    The static analysis (views, live ranges, offsets) is pure Python and
    gives exactly the reference's layout; the numeric work is a batched
    explicit inversion and the divisor folding.
    """
    schedule = fin.schedule
    n_steps = len(schedule)

    # --- pass 1: views, materialized registers, compute levels ------------
    views = {0: ((fin.n, ((0, 0, 1),)),)}   # register -> view
    mreg_len = {0: fin.n}                   # materialized reg -> length
    mreg_def = {0: -1}                      # -> defining schedule position
    computes = []                           # (pos, kind, payload, def_mreg)
    next_mreg = 1
    for p, instr in enumerate(schedule):
        r, op = p + 1, instr[0]
        if op == "slice":
            _, src, lo, hi = instr
            views[r] = _view_slice(views[src], lo, hi)
        elif op == "add":
            _, s1, r1, s2, r2 = instr
            views[r] = _view_add(_view_scale(views[r1], s1),
                                 _view_scale(views[r2], s2))
        elif op == "catneg":
            _, r1, r2 = instr
            views[r] = views[r1] + _view_scale(views[r2], -1)
        elif op == "inv":
            _, bucket, idx, src = instr
            m, next_mreg = next_mreg, next_mreg + 1
            size = fin.lu_stacks[bucket][0].shape[-1]
            mreg_len[m], mreg_def[m] = size, p
            views[r] = ((size, ((m, 0, 1),)),)
            computes.append((p, "inv", (bucket, idx, src), m))
        elif op == "fmvm":
            _, li, src = instr
            lvl = fin.mvm_levels[li]
            m, next_mreg = next_mreg, next_mreg + 1
            out_len = sum(lvl.stacks[refs[0][0]].shape[-2]
                          for refs in lvl.rows)
            mreg_len[m], mreg_def[m] = out_len, p
            views[r] = ((out_len, ((m, 0, 1),)),)
            computes.append((p, "fmvm", (li, src), m))
        else:  # pragma: no cover - finalize only emits the ops above
            raise ValueError(f"unknown schedule op {op!r}")

    # --- pass 2: per-compute input views, last uses ------------------------
    def note_uses(view, p, last_use):
        for _, terms in view:
            for m, _, _ in terms:
                last_use[m] = max(last_use.get(m, mreg_def[m]), p)

    last_use = {0: 0}
    in_views = []       # per compute: view ("inv") or per-tile views ("fmvm")
    for p, kind, payload, _ in computes:
        if kind == "inv":
            view = views[payload[2]]
            note_uses(view, p, last_use)
            in_views.append(view)
        else:
            li, src = payload
            lvl = fin.mvm_levels[li]
            tile_views = []
            for refs in lvl.rows:
                for g, i in refs:
                    lo, hi = lvl.windows[g][i]
                    tv = _view_slice(views[src], lo, hi)
                    note_uses(tv, p, last_use)
                    tile_views.append(tv)
            in_views.append(tuple(tile_views))
    out_view = views[n_steps]
    note_uses(out_view, n_steps, last_use)
    for m in mreg_def:                       # unread defs die immediately
        last_use.setdefault(m, mreg_def[m])

    # --- pass 3: offline allocation over the known live intervals ---------
    intervals = {m: (mreg_len[m], mreg_def[m], last_use[m])
                 for m in mreg_def}
    offsets = _allocate_slots(intervals)
    arena_size = max(offsets[m] + mreg_len[m] for m in mreg_def)
    peak = max(
        sum(mreg_len[m] for m in mreg_def
            if mreg_def[m] <= p <= last_use[m])
        for p in range(-1, n_steps + 1))

    def segs(view):
        """A view as static segments in (mreg, local_off, sign) terms."""
        out, dst = [], 0
        for chunk_len, terms in view:
            out.append((dst, chunk_len, tuple(terms)))
            dst += chunk_len
        return tuple(out)

    # --- pass 4: operator stacks (explicit inverses; sign/divisor folded) -
    stacks = []
    for lu, piv in fin.lu_stacks:
        eye = torch.eye(lu.shape[-1], dtype=lu.dtype, device=lu.device)
        stacks.append(-torch.linalg.lu_solve(lu, piv, eye.expand(lu.shape)))
    mvm_stack_id = {}
    for li, lvl in enumerate(fin.mvm_levels):
        divs = lvl.divs if lvl.divs else (None,) * len(lvl.rows)
        folded = [[None] * s.shape[-3] for s in lvl.stacks]
        for refs, div in zip(lvl.rows, divs):
            for g, i in refs:
                w = -lvl.stacks[g][..., i, :, :]
                if div is not None:
                    w = w / div[..., None]
                folded[g][i] = w
        for g, tiles in enumerate(folded):
            mvm_stack_id[(li, g)] = len(stacks)
            stacks.append(torch.stack(tiles, dim=-3))

    # --- pass 5: levels (schedule order; slot-SSA + arena coordinates) ----
    levels = []
    for (p, kind, payload, m_out), in_view in zip(computes, in_views):
        if kind == "inv":
            bucket, idx, _ = payload
            levels.append(((bucket, idx, m_out, 0, True, segs(in_view)),))
        else:
            li, _ = payload
            lvl = fin.mvm_levels[li]
            tiles, row_off, tv = [], 0, iter(in_view)
            for refs in lvl.rows:
                for pos, (g, i) in enumerate(refs):
                    tiles.append((mvm_stack_id[(li, g)], i, m_out, row_off,
                                  pos == 0, segs(next(tv))))
                row_off += lvl.stacks[refs[0][0]].shape[-2]
            levels.append(tuple(tiles))

    def whole_window(tile):
        sg = tile[5]
        return len(sg) == 1 and sg[0][0] == 0 \
            and sg[0][1] == stacks[tile[0]].shape[-1]

    kernel_ok = all(whole_window(t) for level in levels for t in level)

    # --- pass 6: uniform whole-schedule program ---------------------------
    # When every tile shares one (r, c) shape and reads a whole window (the
    # power-of-two serving configs: a two-stage 256^2 solve is 23 64x64
    # applications), the whole schedule becomes ONE tile program.
    program = None
    if kernel_ok and len({s.shape[-2:] for s in stacks}) == 1:
        seq, offs_l, signs_l, outs_l, init_l = [], [], [], [], []
        n_terms = max(len(t[5][0][2]) for level in levels for t in level)
        for level in levels:
            for sid, idx, m_out, out_local, init, segments in level:
                terms = segments[0][2]
                seq.append(stacks[sid][..., idx, :, :])
                offs_l.append([offsets[m] + o for m, o, _ in terms]
                              + [0] * (n_terms - len(terms)))
                signs_l.append([float(s) for _, _, s in terms]
                               + [0.0] * (n_terms - len(terms)))
                outs_l.append(offsets[m_out] + out_local)
                init_l.append(1 if init else 0)
        dev = stacks[0].device
        program = (torch.stack(seq, dim=-3),
                   torch.tensor(offs_l, dtype=torch.int32, device=dev),
                   torch.tensor(signs_l, dtype=torch.float32, device=dev),
                   torch.tensor(outs_l, dtype=torch.int32, device=dev),
                   torch.tensor(init_l, dtype=torch.int32, device=dev))

    slot_offsets = tuple(offsets[m] for m in range(next_mreg))
    slot_ranges = tuple(
        (offsets[m], mreg_len[m], mreg_def[m], last_use[m])
        for m in range(next_mreg))
    return ArenaPlan(tuple(stacks), fin.scale, program, tuple(levels),
                     segs(out_view), arena_size, fin.n, offsets[0], fin.cfg,
                     kernel_ok, fin.num_arrays, slot_offsets, slot_ranges,
                     peak)


# Registers are (..., rows, k): the rows axis is -2 and any leading axes
# are instances (the packed path), so one cascade serves both forms.

def _slot_gather(vals, segments):
    """Signed static-window gather: the folded slice/add/catneg wiring,
    terms evaluated first to last like the reference executors."""
    parts = []
    for _, seg_len, terms in segments:
        acc = None
        for m, off, sign in terms:
            w = vals[m][..., off:off + seg_len, :]
            w = -w if sign < 0 else w
            acc = w if acc is None else acc + w
        parts.append(acc)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def _arena_out_spec(out_spec, slot_offsets):
    """`out_spec` rebased to physical arena offsets (register 0 = the whole
    arena buffer): the kernel path's output gather."""
    return tuple(
        (dst, ln, tuple((0, slot_offsets[m] + off, sign)
                        for m, off, sign in terms))
        for dst, ln, terms in out_spec)


def _apply_level_plain(vals, stacks, level):
    """One schedule level in slot-SSA form (the plain path).

    A multi-tile level whose tiles share one operator stack runs as one
    batched matmul over the tile axis; the accumulation below replays the
    schedule order (init starts a row part, later tiles add into it).
    """
    parts, m_out = [], level[0][2]
    if len(level) > 1 and len({t[0] for t in level}) == 1:
        sid, idxs = level[0][0], tuple(t[1] for t in level)
        gathers = torch.stack([_slot_gather(vals, t[5]) for t in level],
                              dim=-3)
        lo = idxs[0]
        stack = stacks[sid]
        ops_sel = (stack[..., lo:lo + len(idxs), :, :]
                   if idxs == tuple(range(lo, lo + len(idxs)))
                   else stack[..., list(idxs), :, :])
        outs = ops_sel @ gathers                   # (..., L, rows, k)
        tile_outs = [outs[..., pos, :, :] for pos in range(len(level))]
    else:
        tile_outs = [stacks[sid][..., idx, :, :] @ _slot_gather(vals, segs)
                     for sid, idx, _, _, _, segs in level]
    for out, (_, _, _, _, init, _) in zip(tile_outs, level):
        if init:
            parts.append(out)
        else:
            parts[-1] = parts[-1] + out
    vals[m_out] = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def _run_levels(levels, stacks, b_in):
    """Every level on the plain path; returns the registers (slot-SSA)."""
    vals = {0: b_in}
    for level in levels:
        _apply_level_plain(vals, stacks, level)
    return vals


# ---------------------------------------------------------------------------
# The differentiable cascade (the reference's `_cascade` custom VJP)
#
# The whole cascade, input register to output gather, is one autograd
# operation over (b_in, *stacks); the static metadata (levels, out_spec)
# rides along.  Its forward is the plain level loop or the arena kernel;
# its backward is one reverse sweep over the same operator stacks: each
# tile's input adjoint ops^T @ cot is scattered back through the signed
# windows, and each tile's stack cotangent is cot @ gather^T.  Registers
# and operators are (..., rows, cols) with any leading instance axes, so
# one sweep serves the single and the packed executors.
# ---------------------------------------------------------------------------

def _scatter_ct(cot, lengths, segments, u):
    """Adjoint of `_slot_gather`: scatter-add the cotangent `u` back
    through the signed windows into `cot` (register -> cotangent)."""
    for dst, seg_len, terms in segments:
        piece = u[..., dst:dst + seg_len, :]
        for m, off, sign in terms:
            prev = cot.get(m)
            if prev is None:
                prev = cot[m] = u.new_zeros(u.shape[:-2]
                                            + (lengths[m], u.shape[-1]))
            if sign < 0:
                prev[..., off:off + seg_len, :] -= piece
            else:
                prev[..., off:off + seg_len, :] += piece


def _cascade_backward(levels, out_spec, stacks, b_in, vals, g, need_w):
    """The reverse sweep: returns (b_in's cotangent, one cotangent per
    stack, None where `need_w` is False).  `vals` (the forward's
    registers) is read only for the stack cotangents."""
    lengths = {0: b_in.shape[-2]}
    for level in levels:
        lengths[level[0][2]] = sum(stacks[t[0]].shape[-2]
                                   for t in level if t[4])
    bars = [None] * len(stacks)
    cot = {}                                 # register -> cotangent
    _scatter_ct(cot, lengths, out_spec, g)

    def add_bar(sid, idx, wbar):
        s = stacks[sid]
        if bars[sid] is None:
            bars[sid] = torch.zeros_like(s)
        wbar = wbar.to(s.dtype).sum_to_size(
            s.shape[:-3] + wbar.shape[-3:])
        bars[sid][..., list(idx), :, :] += wbar

    for level in reversed(levels):
        c = cot.pop(level[0][2], None)       # this level's output cotangent
        if c is None:
            continue                         # an unread register
        if len(level) > 1 and len({t[0] for t in level}) == 1:
            # mirror the forward's shared-stack batched matmul
            sid, idxs = level[0][0], tuple(t[1] for t in level)
            rows = stacks[sid].shape[-2]
            cps = torch.stack([c[..., t[3]:t[3] + rows, :] for t in level],
                              dim=-3)
            lo = idxs[0]
            ops_sel = (stacks[sid][..., lo:lo + len(idxs), :, :]
                       if idxs == tuple(range(lo, lo + len(idxs)))
                       else stacks[sid][..., list(idxs), :, :])
            ubars = ops_sel.transpose(-1, -2) @ cps     # (..., L, cols, k)
            if need_w[sid]:
                gathers = torch.stack([_slot_gather(vals, t[5])
                                       for t in level], dim=-3)
                add_bar(sid, idxs, cps @ gathers.transpose(-1, -2))
            for pos, t in enumerate(level):
                _scatter_ct(cot, lengths, t[5], ubars[..., pos, :, :])
        else:
            for sid, idx, _, out_local, _, segments in level:
                op = stacks[sid][..., idx, :, :]
                cp = c[..., out_local:out_local + op.shape[-2], :]
                if need_w[sid]:
                    gat = _slot_gather(vals, segments)
                    add_bar(sid, (idx,),
                            (cp @ gat.transpose(-1, -2)).unsqueeze(-3))
                _scatter_ct(cot, lengths, segments,
                            op.transpose(-1, -2) @ cp)
    b_bar = cot.get(0)
    if b_bar is None:
        b_bar = torch.zeros_like(b_in)
    return b_bar.sum_to_size(b_in.shape), bars


class _Cascade(torch.autograd.Function):
    """The arena cascade as one differentiable operation.

    forward(levels, out_spec, kernel, b_in, *stacks): `kernel` is None
    for the plain level loop, else a function of b_in that runs the arena
    kernel on detached tensors.  The backward reads the forward's
    registers only for a stack gradient: the plain forward keeps them,
    and after the kernel's forward they are recomputed on the plain
    levels (the kernel's arena reuses its slots).
    """

    @staticmethod
    def forward(ctx, levels, out_spec, kernel, b_in, *stacks):
        need_w = ctx.needs_input_grad[4:]
        if kernel is None:
            vals = _run_levels(levels, stacks, b_in)
            out = _slot_gather(vals, out_spec)
        else:
            vals, out = None, kernel(b_in)
        ctx.levels, ctx.out_spec = levels, out_spec
        ctx.vals = vals if any(need_w) else None
        ctx.save_for_backward(b_in, *stacks)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        b_in, *stacks = ctx.saved_tensors
        need_w = ctx.needs_input_grad[4:]
        vals = ctx.vals
        if any(need_w) and vals is None:
            vals = _run_levels(ctx.levels, stacks, b_in)
        b_bar, bars = _cascade_backward(ctx.levels, ctx.out_spec, stacks,
                                        b_in, vals, g, need_w)
        return (None, None, None,
                b_bar if ctx.needs_input_grad[3] else None, *bars)


def _cascade(levels, out_spec, stacks, b_in, kernel=None):
    """The cascade, differentiable in b_in and the stacks: through
    `_Cascade` when autograd records and an input requires grad, else
    straight (`kernel` as in `_Cascade`)."""
    if torch.is_grad_enabled() and (
            b_in.requires_grad or any(s.requires_grad for s in stacks)):
        return _Cascade.apply(levels, out_spec, kernel, b_in, *stacks)
    if kernel is not None:
        return kernel(b_in)
    return _slot_gather(_run_levels(levels, stacks, b_in), out_spec)


def _apply_level_kernel(arena, ap, level):
    """One schedule level on the physical arena: one kernel launch per
    operator stack among the level's tiles, metadata in arena coordinates."""
    from repro_torch.kernels import ops as kops
    so = ap.slot_offsets
    groups = {}
    for tile in level:
        groups.setdefault(tile[0], []).append(tile)
    dev = arena.device
    for sid, tiles in groups.items():
        n_terms = max(len(t[5][0][2]) for t in tiles)
        offs = [[so[m] + o for m, o, _ in t[5][0][2]] for t in tiles]
        signs = [[float(s) for _, _, s in t[5][0][2]] for t in tiles]
        for o, s in zip(offs, signs):       # pad ragged term counts
            o.extend([0] * (n_terms - len(o)))
            s.extend([0.0] * (n_terms - len(s)))
        idx = torch.tensor([t[1] for t in tiles], dtype=torch.long,
                           device=ap.stacks[sid].device)
        arena = kops.arena_level_apply(
            arena, ap.stacks[sid].detach().index_select(0, idx),
            torch.tensor(offs, dtype=torch.int32, device=dev),
            torch.tensor(signs, dtype=torch.float32, device=dev),
            torch.tensor([so[t[2]] + t[3] for t in tiles],
                         dtype=torch.int32, device=dev),
            torch.tensor([1 if t[4] else 0 for t in tiles],
                         dtype=torch.int32, device=dev))
    return arena


def execute_arena(ap: ArenaPlan, b: torch.Tensor,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Run an arena plan; returns x like the other executors.

    `b` may be (n,) or (n, k).  use_kernel=None runs the CUDA kernel for a
    tensor on the card when the plan's windows are whole (`kernel_ok`),
    and the plain path otherwise; True forces the kernel path's arena
    layout (on a CPU tensor the kernel wrapper runs its plain version),
    False forces the plain path.  A uniform plan runs the whole cascade as
    one launch; other whole-window plans launch per level group.
    """
    cfg = ap.cfg
    if use_kernel is None:
        use_kernel = b.is_cuda and ap.kernel_ok
    elif use_kernel and not ap.kernel_ok:
        raise ValueError(
            "use_kernel=True but this plan has ragged (multi-segment) "
            "gather windows the kernel does not express; use the plain "
            "path or an aligned power-of-two configuration")
    single = b.ndim == 1
    dtype = torch.promote_types(b.dtype, ap.scale.dtype)
    bk = b[:, None] if single else b
    b_in = analog.dac(bk, cfg).to(dtype)

    def kernel(b_in):
        from repro_torch.kernels import ops as kops
        arena = torch.zeros((ap.arena_size, b_in.shape[1]), dtype=dtype,
                            device=b_in.device)
        arena[ap.in_off:ap.in_off + ap.n] = b_in.detach()
        if ap.program is not None:
            arena = kops.arena_level_apply(
                arena, *(x.detach() for x in ap.program))
        else:
            for level in ap.levels:
                arena = _apply_level_kernel(arena, ap, level)
        return _slot_gather({0: arena},
                            _arena_out_spec(ap.out_spec, ap.slot_offsets))

    out = _cascade(ap.levels, ap.out_spec, ap.stacks, b_in,
                   kernel if use_kernel else None)
    if single:
        out = out[:, 0]
    return -ap.scale * analog.adc(out, cfg)


def pad_rhs_pow2(bs: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Zero-pad the trailing rhs axis to the next power of two; returns
    (padded batch, original k).  Takes (n, k) or packed (M, n, k)."""
    k = bs.shape[-1]
    k_pad = 1 << (k - 1).bit_length() if k else 0
    if k_pad > k:
        bs = torch.nn.functional.pad(bs, (0, k_pad - k))
    return bs, k


# ---------------------------------------------------------------------------
# Block-level repair
#
# `plan_block_map` enumerates every physical array of a plan - (kind,
# bucket, index) exactly as `compile_plan` interns them - with its path in
# the partition tree.  `repair_blocks` re-programs only the named arrays
# (the whole conductance pipeline, write-verify included; the draw design
# is in the module docstring) and splices them into the FlatPlan stacks;
# `splice_finalized` / `splice_arena` recompute exactly the affected
# slices with the expressions `finalize` / `compile_arena` use.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockRecord:
    """One physical array of a plan: its stack slot and its path.

    `kind`/`bucket`/`index` address the array in FlatPlan.inv_stacks /
    mvm_stacks; `path` is its place in the partition tree, a sequence of
    ("split", 4, idx) steps (idx 0-3: inv1, A2, A3, inv4s) and a final
    ("tile", num, idx) for a tile of A2 or A3 (row-major) - the
    reference's key-derivation path, and here the programming order.
    """
    kind: str          # "inv" | "mvm"
    bucket: int
    index: int
    depth: int
    shape: Tuple[int, int]
    path: tuple

    @property
    def ref(self) -> Tuple[str, int, int]:
        return (self.kind, self.bucket, self.index)


def plan_block_map(n: int, stages: Optional[int],
                   cfg: AnalogConfig) -> Tuple[BlockRecord, ...]:
    """Every physical array of a (n, stages, cfg) plan, in `compile_plan`'s
    emission order (inv1 subtree, A3 tiles, inv4s subtree, A2 tiles), so
    buckets and indices match the FlatPlan's.  Pure Python."""
    if stages is None:
        stages = required_stages(n, cfg.array_size)
    s = cfg.array_size
    inv_buckets: dict = {}
    mvm_buckets: dict = {}
    records = []

    def ref(buckets, key):
        if key not in buckets:
            buckets[key] = [len(buckets), 0]
        b = buckets[key]
        out = (b[0], b[1])
        b[1] += 1
        return out

    def tiles(shape, depth, path):
        rows, cols = shape
        r_t, c_t = -(-rows // s), -(-cols // s)
        for ri in range(r_t):
            for ci in range(c_t):
                tshape = (min((ri + 1) * s, rows) - ri * s,
                          min((ci + 1) * s, cols) - ci * s)
                b, i = ref(mvm_buckets, (depth, tshape))
                records.append(BlockRecord(
                    "mvm", b, i, depth, tshape,
                    path + (("tile", r_t * c_t, ri * c_t + ci),)))

    def walk(tree, depth, path):
        if isinstance(tree, int):
            b, i = ref(inv_buckets, (depth, (tree, tree)))
            records.append(BlockRecord(
                "inv", b, i, depth, (tree, tree), path))
            return
        left, right = tree
        m = _tree_size(left)
        nn = m + _tree_size(right)
        walk(left, depth + 1, path + (("split", 4, 0),))
        tiles((nn - m, m), depth, path + (("split", 4, 2),))   # A3
        walk(right, depth + 1, path + (("split", 4, 3),))
        tiles((m, nn - m), depth, path + (("split", 4, 1),))   # A2

    walk(_split_tree(n, stages), 0, ())
    return tuple(records)


def _target_block(root: Target, path, array_size: int) -> torch.Tensor:
    """The digital target block a BlockRecord's array is programmed from."""
    t = root
    for kind, _, idx in path:
        if kind == "split":
            t = (t.inv1, t.a2, t.a3, t.inv4s)[idx]
        else:
            rows, cols = t.shape
            c_t = -(-cols // array_size)
            ri, ci = idx // c_t, idx % c_t
            t = t[ri * array_size:min((ri + 1) * array_size, rows),
                  ci * array_size:min((ci + 1) * array_size, cols)]
    return t.a if isinstance(t, LeafTarget) else t


def _split_changed(changed):
    """Group a changed-block set into per-bucket sorted index lists."""
    inv: dict = {}
    mvm: dict = {}
    for kind, b, i in changed:
        (inv if kind == "inv" else mvm).setdefault(b, set()).add(i)
    return ({b: sorted(s) for b, s in inv.items()},
            {b: sorted(s) for b, s in mvm.items()})


def _with_rows(t: torch.Tensor, idxs, rows) -> torch.Tensor:
    """A copy of `t` with entries `idxs` of its array axis (-3) replaced
    by the (len(idxs), r, c) stack `rows`."""
    out = t.clone()
    out[..., list(idxs), :, :] = rows
    return out


def repair_blocks(fplan: FlatPlan, parts: PartitionedSystem,
                  cfg: AnalogConfig, blocks, generator: torch.Generator,
                  stages: Optional[int] = None):
    """Re-program only the named physical arrays of a programmed plan.

    `blocks` is an iterable of ("inv"|"mvm", bucket, index) refs.  Each
    named array is re-derived from its digital target block and
    programmed through the whole pipeline (write-verify, variation,
    faults) from the draws a full re-program under `generator` would give
    it (module docstring).  Returns (new FlatPlan, frozenset of changed
    refs); untouched slices are the original arrays, bit for bit.
    """
    recs = plan_block_map(fplan.n, stages, cfg)
    if len(recs) != fplan.num_arrays:
        raise ValueError(
            f"block map has {len(recs)} arrays but the plan holds "
            f"{fplan.num_arrays}: wrong stages for this plan?")
    by_ref = {r.ref: r for r in recs}
    changed = frozenset((k, int(b), int(i)) for k, b, i in blocks)
    for blk in changed:
        if blk not in by_ref:
            raise KeyError(f"no such block in this plan: {blk}")
    new_pairs: dict = {}
    for rec in sorted(recs, key=lambda r: r.path):   # programming order
        a_blk = _target_block(parts.root, rec.path, cfg.array_size)
        draws = analog.pair_draws(rec.shape, generator, cfg.nonideal,
                                  torch.result_type(a_blk, parts.scale))
        if rec.ref in changed:
            new_pairs[rec.ref] = analog.map_matrix_drawn(
                a_blk, [draws], cfg, parts.scale)
    changed_inv, changed_mvm = _split_changed(changed)

    def splice(stacks, per_bucket, kind):
        out = list(stacks)
        for b, idxs in per_bucket.items():
            g = out[b]
            pairs = [new_pairs[(kind, b, i)] for i in idxs]
            out[b] = TileGrid(
                _with_rows(g.gpos, idxs, torch.cat([p.gpos for p in pairs])),
                _with_rows(g.gneg, idxs, torch.cat([p.gneg for p in pairs])),
                g.scale, g.g0)
        return tuple(out)

    return (dataclasses.replace(
        fplan, inv_stacks=splice(fplan.inv_stacks, changed_inv, "inv"),
        mvm_stacks=splice(fplan.mvm_stacks, changed_mvm, "mvm")), changed)


def _mvm_level_layout(fplan: FlatPlan):
    """Replay `_finalize_mvm_level`'s shape grouping: per "mvm" schedule
    level, its rows as tuples of (bucket, index, group, pos) - a tile's
    FlatPlan slot and its place in the finalized level."""
    layouts = []
    for instr in fplan.schedule:
        if instr[0] != "mvm":
            continue
        groups: dict = {}
        counts: list = []
        row_tiles = []
        for row in instr[1]:
            rt = []
            for bk, i in row:
                shape = fplan.mvm_stacks[bk].shape[-2:]
                if shape not in groups:
                    groups[shape] = len(counts)
                    counts.append(0)
                g = groups[shape]
                rt.append((bk, i, g, counts[g]))
                counts[g] += 1
            row_tiles.append(tuple(rt))
        layouts.append(tuple(row_tiles))
    return tuple(layouts)


def splice_finalized(fin: FinalizedPlan, fplan: FlatPlan, changed,
                     r_wire=None, drift_t=None) -> FinalizedPlan:
    """Propagate repaired FlatPlan slices into a FinalizedPlan.

    Recomputes, with `finalize`'s expressions, the changed INV arrays'
    operators and LU factors (batched over the changed subset), the
    changed MVM tiles' operators (one readout per bucket's changed
    subset) and the divisors of every tile-row holding a changed tile;
    everything else is carried over.  `drift_t` gives the recomputed
    slices' ages (`finalize`'s; None: the config's age, fresh).
    """
    cfg = fin.cfg
    inv_ages, mvm_ages = _split_ages(fplan, drift_t)
    changed_inv, changed_mvm = _split_changed(changed)
    lu_stacks = list(fin.lu_stacks)
    for b, idxs in changed_inv.items():
        grid = fplan.inv_stacks[b]
        sel = torch.tensor(idxs, device=grid.gpos.device)
        sub = TileGrid(grid.gpos[..., sel, :, :], grid.gneg[..., sel, :, :],
                       grid.scale, grid.g0)
        lu_s, piv_s = _lu_factor(_inv_operators(
            sub, cfg, r_wire=r_wire, drift_t=_ages_at(inv_ages, b, sel)))
        lu, piv = lu_stacks[b]
        piv = piv.clone()
        piv[..., idxs, :] = piv_s
        lu_stacks[b] = (_with_rows(lu, idxs, lu_s), piv)

    eff = {}                                 # changed (bucket, index) -> op
    for b, idxs in changed_mvm.items():
        grid = fplan.mvm_stacks[b]
        sel = torch.tensor(idxs, device=grid.gpos.device)
        sub = TileGrid(grid.gpos[..., sel, :, :], grid.gneg[..., sel, :, :],
                       grid.scale, grid.g0)
        ops = sub.a_eff(cfg, r_wire=r_wire, drift_t=_ages_at(mvm_ages, b, sel))
        for pos, i in enumerate(idxs):
            eff[(b, i)] = ops[..., pos, :, :]
    mvm_levels = list(fin.mvm_levels)
    for li, row_tiles in enumerate(_mvm_level_layout(fplan)):
        lvl = mvm_levels[li]
        new_stacks = list(lvl.stacks)
        new_divs = list(lvl.divs)
        touched = False
        for r_idx, rt in enumerate(row_tiles):
            if not any((bk, i) in eff for bk, i, _, _ in rt):
                continue
            touched = True
            load = cfg.g0
            for bk, i, g, pos in rt:
                pair = fplan.mvm_stacks[bk].tile(i)
                if (bk, i) in eff:
                    new_stacks[g] = _with_rows(new_stacks[g], [pos],
                                               eff[(bk, i)].unsqueeze(-3))
                load = load + torch.sum(pair.gpos + pair.gneg, dim=-1)
            if new_divs:
                new_divs[r_idx] = 1.0 + load / (cfg.opa_gain * cfg.g0)
        if touched:
            mvm_levels[li] = dataclasses.replace(
                lvl, stacks=tuple(new_stacks), divs=tuple(new_divs))
    return dataclasses.replace(fin, lu_stacks=tuple(lu_stacks),
                               mvm_levels=tuple(mvm_levels))


def splice_arena(ap: ArenaPlan, fin: FinalizedPlan, fplan: FlatPlan,
                 changed) -> ArenaPlan:
    """Propagate a spliced FinalizedPlan (`splice_finalized`'s result)
    into an ArenaPlan: the changed INV arrays' explicit inverses, the
    changed MVM tiles and every tile sharing a row with one (their common
    divisor is folded in), and the uniform program's operators at those
    tiles - `compile_arena`'s expressions, slice by slice."""
    changed_inv, changed_mvm = _split_changed(changed)
    changed_set = {(b, i) for b, idxs in changed_mvm.items() for i in idxs}
    stacks = list(ap.stacks)
    updated = set()
    for b, idxs in changed_inv.items():
        lu, piv = fin.lu_stacks[b]
        lu_s, piv_s = lu[..., idxs, :, :], piv[..., idxs, :]
        eye = torch.eye(lu.shape[-1], dtype=lu.dtype, device=lu.device)
        stacks[b] = _with_rows(
            stacks[b], idxs,
            -torch.linalg.lu_solve(lu_s, piv_s, eye.expand(lu_s.shape)))
        updated.update((b, i) for i in idxs)

    sid_of = {}
    next_id = len(fin.lu_stacks)
    for li, lvl in enumerate(fin.mvm_levels):
        for g in range(len(lvl.stacks)):
            sid_of[(li, g)] = next_id
            next_id += 1
    for li, row_tiles in enumerate(_mvm_level_layout(fplan)):
        lvl = fin.mvm_levels[li]
        divs = lvl.divs if lvl.divs else (None,) * len(row_tiles)
        for r_idx, rt in enumerate(row_tiles):
            if not any((bk, i) in changed_set for bk, i, _, _ in rt):
                continue
            div = divs[r_idx]
            for bk, i, g, pos in rt:
                if div is None and (bk, i) not in changed_set:
                    continue
                w = -lvl.stacks[g][..., pos, :, :]
                if div is not None:
                    w = w / div[..., None]
                sid = sid_of[(li, g)]
                stacks[sid] = _with_rows(stacks[sid], [pos], w.unsqueeze(-3))
                updated.add((sid, pos))

    program = ap.program
    if program is not None and updated:
        positions, ops = [], []
        p = 0
        for level in ap.levels:
            for tile in level:
                if (tile[0], tile[1]) in updated:
                    positions.append(p)
                    ops.append(stacks[tile[0]][..., tile[1], :, :])
                p += 1
        program = (_with_rows(program[0], positions,
                              torch.stack(ops, dim=-3)),) + program[1:]
    return dataclasses.replace(ap, stacks=tuple(stacks), program=program)


# ---------------------------------------------------------------------------
# Program-once / solve-many handle
# ---------------------------------------------------------------------------

class ProgrammedSolver:
    """Program-once / solve-many handle over one finalized matrix.

    `program` pays the programming cost once (partition, Schur complements,
    conductance mapping, finalization, arena compilation); `solve` /
    `solve_many` then stream right-hand sides.  mode="fused" (default) runs
    the arena executor - the CUDA kernel on the card - and "reference" the
    finalized schedule.

    Maintenance state: the flat plan (the raw conductances - drift is a
    readout effect, so `aged` re-finalizes from it without re-programming)
    and the partitioned system with the resolved stage count (`repaired`
    re-derives target blocks from them).  Both are optional: a solver
    built without them cannot be aged or repaired.
    """

    def __init__(self, fin: FinalizedPlan, arena: Optional[ArenaPlan] = None,
                 mode: str = "fused", fplan: Optional[FlatPlan] = None,
                 parts: Optional[PartitionedSystem] = None,
                 stages: Optional[int] = None):
        if mode not in ("reference", "fused"):
            raise ValueError(f"mode must be 'reference' or 'fused', "
                             f"got {mode!r}")
        self._fin = fin
        # fused solvers pay the arena compile at programming time; the
        # reference mode compiles it on first fused use, if ever
        if arena is None and mode == "fused":
            arena = compile_arena(fin)
        self._arena = arena
        self._mode = mode
        self._fplan = fplan
        self._parts = parts
        self._stages = stages

    @classmethod
    def program(cls, a, generator: torch.Generator, cfg: AnalogConfig,
                stages: Optional[int] = None, mode: str = "fused",
                device="cuda") -> "ProgrammedSolver":
        """Full programming flow for matrix A (one noise draw) on `device`."""
        a = torch.as_tensor(a, device=resolve_device(device))
        parts = partition_system(a, cfg, stages)
        if stages is None:
            stages = required_stages(a.shape[0], cfg.array_size)
        return cls.from_plan(program_system(parts, generator, cfg), cfg,
                             mode=mode, parts=parts, stages=stages)

    @classmethod
    def from_plan(cls, plan: Union[SolvePlan, FlatPlan], cfg: AnalogConfig,
                  mode: str = "fused",
                  parts: Optional[PartitionedSystem] = None,
                  stages: Optional[int] = None) -> "ProgrammedSolver":
        """Finalize an already-built plan (recursive or flat)."""
        fplan = plan if isinstance(plan, FlatPlan) else compile_plan(plan)
        return cls(finalize(fplan, cfg), mode=mode, fplan=fplan,
                   parts=parts, stages=stages)

    @property
    def arena(self) -> ArenaPlan:
        if self._arena is None:
            self._arena = compile_arena(self._fin)
        return self._arena

    @property
    def finalized(self) -> FinalizedPlan:
        return self._fin

    @property
    def flat(self) -> Optional[FlatPlan]:
        return self._fplan

    @property
    def stages(self) -> Optional[int]:
        return self._stages

    @property
    def ageable(self) -> bool:
        """Can this solver be re-finalized at new device ages?"""
        return self._fplan is not None

    @property
    def repairable(self) -> bool:
        """Can this solver re-program individual blocks in place?"""
        return self._fplan is not None and self._parts is not None \
            and self._stages is not None

    def block_map(self) -> Tuple[BlockRecord, ...]:
        """Every physical array of this plan (needs the stage count)."""
        if self._stages is None:
            raise ValueError("solver was built without a resolved stage "
                             "count; block map unavailable")
        return plan_block_map(self._fin.n, self._stages, self._fin.cfg)

    def aged(self, drift_t) -> "ProgrammedSolver":
        """This solver with its readout evaluated at new device ages
        (`finalize`'s `drift_t`: a scalar or a `PlanAges`).  The
        conductance stacks are shared, not copied."""
        if self._fplan is None:
            raise ValueError("solver does not retain its flat plan; aging "
                             "unavailable")
        fin = finalize(self._fplan, self._fin.cfg, drift_t=drift_t)
        arena = compile_arena(fin) if self._arena is not None else None
        return ProgrammedSolver(fin, arena, self._mode, fplan=self._fplan,
                                parts=self._parts, stages=self._stages)

    def repaired(self, blocks, generator: torch.Generator,
                 drift_t=None) -> "ProgrammedSolver":
        """Block-level repair: re-program only `blocks` (see `block_map`)
        from `generator` and splice them in place.  `drift_t` (`finalize`
        semantics) gives the ages the recomputed slices are read at; None
        means fresh.  Repairing every block equals a full re-program under
        the same generator state (module docstring)."""
        if not self.repairable:
            raise ValueError("solver does not retain its partitioned "
                             "system; block repair unavailable - fall back "
                             "to a full re-program")
        fplan, changed = repair_blocks(self._fplan, self._parts,
                                       self._fin.cfg, blocks, generator,
                                       stages=self._stages)
        fin = splice_finalized(self._fin, fplan, changed, drift_t=drift_t)
        arena = None
        if self._arena is not None:
            arena = splice_arena(self._arena, fin, fplan, changed)
        return ProgrammedSolver(fin, arena, self._mode, fplan=fplan,
                                parts=self._parts, stages=self._stages)

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def cfg(self) -> AnalogConfig:
        return self._fin.cfg

    @property
    def n(self) -> int:
        return self._fin.n

    @property
    def num_arrays(self) -> int:
        return self._fin.num_arrays

    @property
    def device(self) -> torch.device:
        return self._fin.scale.device

    def solve(self, b: torch.Tensor, mode: Optional[str] = None
              ) -> torch.Tensor:
        """Solve A x = b for one (n,) rhs or an (n, k) batch."""
        mode = self._mode if mode is None else mode
        if mode == "reference":
            return execute_finalized(self._fin, b)
        return execute_arena(self.arena, b)

    def solve_many(self, bs: torch.Tensor, mode: Optional[str] = None,
                   pad_to_pow2: bool = True) -> torch.Tensor:
        """Solve an (n, k) batch in one call; the batch is zero-padded to a
        power of two (the serving layer's one padding policy) and the
        padding sliced away."""
        k = bs.shape[1]
        if k == 0:
            return torch.zeros_like(bs)
        if pad_to_pow2:
            bs, k = pad_rhs_pow2(bs)
        xs = self.solve(bs, mode=mode)
        return xs[:, :k] if xs.shape[1] > k else xs


# ---------------------------------------------------------------------------
# Packed multi-tenant serving: one dispatch over (instances x rhs)
#
# Every static artifact of the compile pipeline is a function of
# (n, stages, cfg) alone, so plans of one `plan_signature` share one
# schedule and arena layout and stack on a leading instance axis.
# ---------------------------------------------------------------------------

def plan_signature(n: int, stages: Optional[int], cfg: AnalogConfig):
    """Structural signature of the compile pipeline for (n, stages, cfg):
    equal signatures imply identical schedules and arena layouts."""
    if stages is None:
        stages = required_stages(n, cfg.array_size)
    return ("blockamc", int(n), int(stages), _split_tree(n, stages), cfg)


def pack_partitioned(parts_seq) -> PartitionedSystem:
    """Stack same-signature PartitionedSystems leaf by leaf on a leading
    instance axis; raises ValueError when their partition trees differ
    (the reference's `jnp.stack` over the pytrees checks the same)."""
    parts_seq = list(parts_seq)
    if not parts_seq:
        raise ValueError("pack_partitioned needs at least one system")

    def stack(nodes):
        first = nodes[0]
        if any(type(t) is not type(first) for t in nodes):
            raise ValueError("partitioned systems are not stackable: their "
                             "partition trees differ")
        if isinstance(first, LeafTarget):
            return LeafTarget(_stack_leaves([t.a for t in nodes]))
        if any(t.m != first.m for t in nodes):
            raise ValueError("partitioned systems are not stackable: their "
                             "splits differ")
        return BlockTarget(stack([t.inv1 for t in nodes]),
                           _stack_leaves([t.a2 for t in nodes]),
                           _stack_leaves([t.a3 for t in nodes]),
                           stack([t.inv4s for t in nodes]), first.m)

    return PartitionedSystem(stack([p.root for p in parts_seq]),
                             _stack_leaves([p.scale for p in parts_seq]))


def _stack_leaves(xs) -> torch.Tensor:
    if len({tuple(x.shape) for x in xs}) != 1:
        raise ValueError(f"partitioned systems are not stackable: leaf "
                         f"shapes {sorted({tuple(x.shape) for x in xs})}")
    return torch.stack(xs)


def program_system_batched(parts_seq: Sequence[PartitionedSystem],
                           generators: Sequence[torch.Generator],
                           cfg: AnalogConfig):
    """Program and flat-compile M instances, one generator each; returns
    the list of FlatPlans (programming is offline, so a loop is fine)."""
    return [compile_plan(program_system(p, g, cfg))
            for p, g in zip(parts_seq, generators, strict=True)]


def finalize_batched(fplans: Sequence[FlatPlan], cfg: AnalogConfig):
    """`finalize` over a list of instances."""
    return [finalize(fp, cfg) for fp in fplans]


@dataclasses.dataclass
class PackedArenaPlan:
    """M same-signature ArenaPlans stacked on a leading instance axis.

    `stacks[i]` is (M, L, r, c); `scale` is (M,).  The static metadata is
    the one shared copy every instance was compiled to.  For uniform plans
    `program_ops` is the (M, T, r, c) operator sequence and `program_meta`
    the shared (in_offs, in_signs, out_offs, out_init).
    """
    stacks: tuple
    scale: torch.Tensor
    program_ops: Optional[torch.Tensor]
    program_meta: Optional[tuple]
    levels: tuple
    out_spec: tuple
    arena_size: int
    n: int
    in_off: int
    cfg: AnalogConfig
    kernel_ok: bool
    num_arrays: int
    slot_offsets: tuple
    num_instances: int


# Static ArenaPlan metadata that must agree for plans to share one packed
# program (the mechanical form of the signature-stackability invariant).
_STACKABLE_FIELDS = ("levels", "out_spec", "arena_size", "n", "in_off",
                     "cfg", "kernel_ok", "slot_offsets")


def pack_arena_plans(aps) -> PackedArenaPlan:
    """Stack already-compiled same-signature ArenaPlans into a packed plan;
    raises ValueError when their static structure differs."""
    aps = list(aps)
    if not aps:
        raise ValueError("pack_arena_plans needs at least one plan")
    ap0 = aps[0]
    for ap in aps[1:]:
        for f in _STACKABLE_FIELDS:
            if getattr(ap, f) != getattr(ap0, f):
                raise ValueError(
                    f"arena plans are not stackable: static field {f!r} "
                    f"differs (plans compiled from different "
                    f"plan_signature buckets?)")
    stacks = tuple(torch.stack([ap.stacks[i] for ap in aps])
                   for i in range(len(ap0.stacks)))
    scale = torch.stack([ap.scale for ap in aps])
    program_ops = program_meta = None
    if ap0.program is not None:
        program_ops = torch.stack([ap.program[0] for ap in aps])
        program_meta = ap0.program[1:]
    return PackedArenaPlan(stacks, scale, program_ops, program_meta,
                           ap0.levels, ap0.out_spec, ap0.arena_size, ap0.n,
                           ap0.in_off, ap0.cfg, ap0.kernel_ok,
                           ap0.num_arrays, ap0.slot_offsets, len(aps))


def compile_arena_batched(fins: Sequence[FinalizedPlan]) -> PackedArenaPlan:
    """`compile_arena` over a list of instances, packed."""
    return pack_arena_plans(compile_arena(f) for f in fins)


def program_packed(As, generators: Sequence[torch.Generator],
                   cfg: AnalogConfig, stages: Optional[int] = None,
                   device="cuda") -> PackedArenaPlan:
    """Full programming flow for an (M, n, n) matrix stack on `device`, one
    generator per matrix.  All matrices share one `plan_signature`."""
    As = torch.as_tensor(As, device=resolve_device(device))
    parts = [partition_system(a, cfg, stages) for a in As]
    fplans = program_system_batched(parts, generators, cfg)
    return compile_arena_batched(finalize_batched(fplans, cfg))


def execute_arena_packed(pp: PackedArenaPlan, bs: torch.Tensor,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Run the whole packed fleet; returns per-instance solutions.

    `bs` is (M, n) or (M, n, k).  The plain path runs every level as one
    stacked-tile matmul whose batch dims carry the instance axis.  The
    kernel path runs all instances' cascades as ONE launch over an
    (M, S, K) arena stack; use_kernel=None takes it for a tensor on the
    card when the plan is uniform, True forces it, False forces plain.
    """
    cfg = pp.cfg
    uniform = pp.kernel_ok and pp.program_ops is not None
    if use_kernel is None:
        use_kernel = bs.is_cuda and uniform
    elif use_kernel and not uniform:
        raise ValueError(
            "use_kernel=True but this packed plan has no uniform "
            "whole-schedule program (ragged windows or mixed tile "
            "shapes); use the plain path or a power-of-two configuration")
    single = bs.ndim == 2
    dtype = torch.promote_types(bs.dtype, pp.scale.dtype)
    bk = bs[..., None] if single else bs
    b_in = analog.dac(bk, cfg).to(dtype)

    def kernel(b_in):
        from repro_torch.kernels import ops as kops
        arena = torch.zeros((b_in.shape[0], pp.arena_size, b_in.shape[2]),
                            dtype=dtype, device=b_in.device)
        arena[:, pp.in_off:pp.in_off + pp.n] = b_in.detach()
        arena = kops.arena_packed_apply(arena, pp.program_ops.detach(),
                                        *pp.program_meta)
        return _slot_gather({0: arena},
                            _arena_out_spec(pp.out_spec, pp.slot_offsets))

    out = _cascade(pp.levels, pp.out_spec, pp.stacks, b_in,
                   kernel if use_kernel else None)
    if single:
        out = out[..., 0]
    scale = pp.scale.reshape((-1,) + (1,) * (out.ndim - 1))
    return -scale * analog.adc(out, cfg)


def execute_arena_packed_sharded(pp: PackedArenaPlan, bs: torch.Tensor,
                                 mesh=None, axis_name: str = "mc",
                                 use_kernel: Optional[bool] = None
                                 ) -> torch.Tensor:
    """`execute_arena_packed` with the instance axis split over a mesh.

    Each rank runs its own share of the packed fleet (operator stacks,
    scales, whole-schedule operators and right-hand sides carry the
    instance axis; the shared window-program metadata is whole on every
    rank - specs `sharding.partition.mc_packed_specs`), and the shares come
    back gathered in rank order.  num_instances must divide over the axis.
    mesh=None builds `launch.mesh.make_mc_mesh` on bs's device.
    """
    from repro_torch.sharding import partition as sp
    mesh, rank, count = sp.mc_rank(mesh, axis_name, pp.num_instances,
                                   "num_instances", bs.device)
    (plan_spec, b_spec), out_spec = sp.mc_packed_specs(pp, axis_name)
    xs = execute_arena_packed(sp.take_share(pp, plan_spec, rank, count),
                              sp.take_share(bs, b_spec, rank, count),
                              use_kernel=use_kernel)
    return sp.gather_shares(xs, mesh, out_spec)


# ---------------------------------------------------------------------------
# Monte-Carlo drivers: one programmed plan per generator, batched
#
# The reference vmaps programming and execution over PRNG keys.  Here the
# simulations are a leading axis of the conductance stacks: one plan
# programmed from the sequence of generators (one per simulation, each
# drawing in the single-plan order), so every readout of a bucket - one
# nodal readout under `wire_model="nodal"` - sees all simulations at once,
# (S * num, r, c), and every schedule level is one batched op.
# ---------------------------------------------------------------------------

def _packed_simulations(ap: ArenaPlan, sims: int) -> PackedArenaPlan:
    """An arena plan compiled from a Monte-Carlo plan (operators (S, L, r,
    c)) as the packed plan of its S simulations."""
    return PackedArenaPlan(
        ap.stacks, ap.scale.expand(sims),
        None if ap.program is None else ap.program[0],
        None if ap.program is None else ap.program[1:],
        ap.levels, ap.out_spec, ap.arena_size, ap.n, ap.in_off, ap.cfg,
        ap.kernel_ok, ap.num_arrays, ap.slot_offsets, sims)


def solve_batched(a: torch.Tensor, b: torch.Tensor,
                  generators: Sequence[torch.Generator], cfg: AnalogConfig,
                  stages: Optional[int] = None, mode: str = "reference",
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Batched Monte-Carlo BlockAMC solve, one simulation per generator.

    The noise-independent pre-processing (partitioning, Schur complements,
    normalisation) runs once; programming and execution are batched over
    the simulations.  mode="reference" runs `execute_flat` (the
    accuracy-study path); mode="fused" finalizes, arena-compiles and runs
    the simulations as one packed arena execution (one kernel launch on
    the card for a uniform plan).  `b` is (n,) or (n, k); returns (S, n) or
    (S, n, k).  `use_kernel` picks the kernels or their plain versions for
    the nodal write-verify and the readouts and, in fused mode, the arena
    execution (None: the kernels for CUDA tensors).
    """
    if mode not in ("reference", "fused"):
        raise ValueError(f"mode must be 'reference' or 'fused', got "
                         f"{mode!r}")
    gens = list(generators)
    fplan = compile_plan(program_system(partition_system(a, cfg, stages),
                                        gens, cfg, use_kernel=use_kernel))
    if mode == "reference":
        return execute_flat(fplan, b, cfg, use_kernel=use_kernel)
    ap = compile_arena(finalize(fplan, cfg, use_kernel=use_kernel))
    return execute_arena_packed(_packed_simulations(ap, len(gens)),
                                b.expand((len(gens),) + tuple(b.shape)),
                                use_kernel=use_kernel)


def solve_batched_sharded(a: torch.Tensor, b: torch.Tensor,
                          generators: Sequence[torch.Generator],
                          cfg: AnalogConfig, stages: Optional[int] = None,
                          mesh=None, axis_name: str = "mc",
                          mode: str = "reference",
                          use_kernel: Optional[bool] = None) -> torch.Tensor:
    """`solve_batched` with the simulations split over a mesh axis.

    Each rank programs and solves its own share of the generators (specs
    `sharding.partition.mc_solve_specs`); the system and right-hand sides
    are whole on every rank, and the shares come back gathered in rank
    order, so every rank holds the (S, n) / (S, n, k) result.  A rank's
    share draws what the unsharded call draws for it.  The number of
    generators must divide over the axis.  mesh=None builds
    `launch.mesh.make_mc_mesh` on a's device.
    """
    from repro_torch.sharding import partition as sp
    gens = list(generators)
    mesh, rank, count = sp.mc_rank(mesh, axis_name, len(gens), "num_keys",
                                   a.device)
    (_, _, gspec), out_spec = sp.mc_solve_specs(axis_name)
    xs = solve_batched(a, b, sp.take_share(gens, gspec, rank, count), cfg,
                       stages, mode, use_kernel)
    return sp.gather_shares(xs, mesh, out_spec)


def solve_original_batched(a: torch.Tensor, b: torch.Tensor,
                           generators: Sequence[torch.Generator],
                           cfg: AnalogConfig,
                           use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Batched Monte-Carlo baseline: original (monolithic) AMC solve, one
    simulation per generator; returns (S, n) or (S, n, k).  `use_kernel`
    as in `solve_batched`."""
    fplan = compile_plan(build_original_plan(a, list(generators), cfg,
                                             use_kernel=use_kernel))
    return execute_flat(fplan, b, cfg, use_kernel=use_kernel)
