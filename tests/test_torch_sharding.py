"""The port's Monte-Carlo mesh (`launch/mesh.make_mc_mesh`,
`sharding/partition`'s `mc_*_specs`, the three `*_sharded` solvers) and
the mesh argument of `core/distributed.py`, against the unsharded port
and the JAX package.

On one rank a sharded call is the unsharded call on the whole axis, so
the two are equal bit for bit.  Against JAX the solvers run at sigma=0
(no noise drawn) or on noisy packed plans JAX programmed, carried across
with `repro_torch.interop`.  Tolerances: the reference path 1e-5 of
max|x| (the same op order, other matmul and LAPACK kernels); arena-form
paths rtol 2e-4 of max|x| (TESTING.md's executor contract); the refined
solves in float64 at 1e-8 of max|x| (both converge to tol 1e-10 on cond
1e2).  Four gloo ranks in subprocesses run the sharded calls for real: a
rank's share draws and computes what the unsharded call does for it, so
the gathered result equals the unsharded one bit for bit on the host;
the 2x2 ("data", "model") tile solver only reassociates its partial
sums, 1e-6 of max|x|.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import hybrid as jh
from repro.core import blockamc as jb
from repro.core.analog import AnalogConfig as JCfg
from repro.core.nonideal import NonidealConfig as JNi
from repro.launch.mesh import make_mc_mesh as jax_mc_mesh
from repro_torch import hybrid as th
from repro_torch import interop
from repro_torch.core import blockamc as tb
from repro_torch.core import hybrid as tshim
from repro_torch.launch import mesh as tmesh
from repro_torch.sharding import partition as tpart
from _torch_parity import flat_plan_dict, scaled_close, t, torch_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def mesh():
    """A one-rank gloo mesh; the group it starts is destroyed after."""
    assert not dist.is_initialized()
    m = tmesh.make_mc_mesh(device="cpu")
    yield m
    dist.destroy_process_group()


def _wishart(n, seed):
    x = np.random.default_rng(seed).normal(size=(4 * n, n))
    return (x.T @ x / (4 * n)).astype(np.float32)


def _rhs(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape) \
        .astype(np.float32)


def _gens(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


def test_make_mc_mesh_starts_a_one_rank_group_and_names_its_axis():
    assert not dist.is_initialized()
    try:
        m = tmesh.make_mc_mesh(axis_name="keys", device="cpu")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert m.mesh_dim_names == ("keys",) and tuple(m.shape) == (1,)
        assert tpart.axis_size(m, "keys") == 1
        assert tuple(tmesh.make_mc_mesh(device="cpu").shape) == (1,)
        with pytest.raises(ValueError, match="world"):
            tmesh.make_mc_mesh(2, device="cpu")
    finally:
        dist.destroy_process_group()
    try:        # the language model's meshes on the same one-rank world
        m = tmesh.make_host_mesh(device="cpu")
        assert m.mesh_dim_names == ("data", "model")
        assert tuple(m.shape) == (1, 1)
        for fn in (lambda: tmesh.make_host_mesh(2, 1, device="cpu"),
                   lambda: tmesh.make_production_mesh(device="cpu")):
            with pytest.raises(ValueError, match="the world has 1"):
                fn()
    finally:
        dist.destroy_process_group()


def test_mc_specs_match_the_reference_layout():
    assert tpart.mc_solve_specs() == ((None, None, "mc"), "mc")
    assert tpart.mc_refined_specs("k") == ((None, None, None, "k"), "k")
    cfg = torch_cfg(JCfg(array_size=4, nonideal=JNi(sigma=0.05)))
    As = np.stack([_wishart(16, i) for i in range(4)])
    pp = tb.program_packed(As, _gens(range(4)), cfg, 2, device="cpu")
    (spec, bspec), out = tpart.mc_packed_specs(pp)
    assert bspec == out == "mc" and spec.scale == "mc"
    assert spec.stacks == ("mc",) * len(pp.stacks)
    assert spec.program_ops == "mc"
    assert spec.program_meta == (None,) * len(pp.program_meta)
    share = tpart.take_share(pp, spec, 1, 2)
    assert share.num_instances == 2
    assert torch.equal(share.program_ops, pp.program_ops[2:4])
    assert torch.equal(share.scale, pp.scale[2:4])
    for s, whole in zip(share.stacks, pp.stacks):
        assert torch.equal(s, whole[2:4])
    assert all(x is y for x, y in zip(share.program_meta,
                                      pp.program_meta))     # replicated
    with pytest.raises(ValueError, match="divide"):
        tpart.take_share(pp, spec, 0, 3)


@pytest.mark.parametrize("mode", ["reference", "fused"])
def test_solve_batched_sharded_equals_unsharded_and_jax(mesh, mode):
    """The oracles `test_programmed_solver.py:138` and
    `test_fused_arena.py:158` at sigma=0, held to JAX's sharded call."""
    a, b = _wishart(32, 1), _rhs(32, 2)
    jcfg = JCfg(array_size=16)
    tcfg = torch_cfg(jcfg)
    out = tb.solve_batched_sharded(t(a), t(b), _gens(range(4)), tcfg,
                                   stages=1, mesh=mesh, mode=mode)
    assert out.shape == (4, 32)
    assert torch.equal(out, tb.solve_batched(t(a), t(b), _gens(range(4)),
                                             tcfg, stages=1, mode=mode))
    want = jb.solve_batched_sharded(
        jnp.asarray(a), jnp.asarray(b),
        jax.random.split(jax.random.PRNGKey(0), 4), jcfg, stages=1,
        mesh=jax_mc_mesh(1), mode=mode)
    scaled_close(out, want, 1e-5 if mode == "reference" else 2e-4)
    # noisy: one generator per simulation, so the mesh changes no draw
    ncfg = torch_cfg(JCfg(array_size=16, nonideal=JNi(sigma=0.05)))
    assert torch.equal(
        tb.solve_batched_sharded(t(a), t(b), _gens(range(4)), ncfg,
                                 stages=1, mesh=mesh, mode=mode),
        tb.solve_batched(t(a), t(b), _gens(range(4)), ncfg, stages=1,
                         mode=mode))


def test_solve_batched_sharded_default_mesh_follows_the_tensors():
    """mesh=None builds `make_mc_mesh` on the inputs' device, starting a
    one-rank group where none exists."""
    a, b = _wishart(16, 3), _rhs(16, 4)
    cfg = torch_cfg(JCfg(array_size=8, nonideal=JNi(sigma=0.05)))
    assert not dist.is_initialized()
    try:
        out = tb.solve_batched_sharded(t(a), t(b), _gens((5, 6)), cfg,
                                       stages=1)
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    assert torch.equal(out, tb.solve_batched(t(a), t(b), _gens((5, 6)), cfg,
                                             stages=1))


def test_execute_arena_packed_sharded_on_carried_noisy_plans(mesh):
    """`test_packed_serving.py:167`'s case: four noisy plans JAX
    programmed, carried across, packed, and run over the instance axis."""
    jcfg = JCfg(array_size=8, nonideal=JNi(sigma=0.05))
    tcfg = torch_cfg(jcfg)
    jsolvers, tplans = [], []
    for i in range(4):
        js = jb.ProgrammedSolver.program(jnp.asarray(_wishart(16, 10 + i)),
                                         jax.random.PRNGKey(i), jcfg, 1)
        jsolvers.append(js)
        tplans.append(interop.solver_from_numpy(flat_plan_dict(js.flat),
                                                tcfg, device="cpu").arena)
    jpp = jb.pack_arena_plans([s.arena for s in jsolvers])
    tpp = tb.pack_arena_plans(tplans)
    bs = _rhs((4, 16, 3), 20)
    out = tb.execute_arena_packed_sharded(tpp, t(bs), mesh=mesh)
    assert out.shape == (4, 16, 3)
    assert torch.equal(out, tb.execute_arena_packed(tpp, t(bs)))
    want = jb.execute_arena_packed_sharded(jpp, jnp.asarray(bs),
                                           mesh=jax_mc_mesh(1))
    scaled_close(out, want, 2e-4)


def test_solve_refined_batched_sharded_equals_unsharded_and_jax(mesh):
    """`test_hybrid_krylov.py:186`'s case (that module fails at import on
    this jax, so the JAX function is called directly) at sigma=0, in
    float64: every field of the KrylovResult comes back on the key axis."""
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.normal(size=(32, 32)))
    a = (q * np.geomspace(1.0, 1e2, 32)) @ q.T
    b = rng.uniform(-1, 1, 32)
    jcfg = JCfg(array_size=16)
    kw = dict(stages=1, method="gmres", tol=1e-10, maxiter=320, restart=16)
    res = th.solve_refined_batched_sharded(
        t(a), t(b), _gens(range(4)), torch_cfg(jcfg), mesh=mesh,
        device="cpu", **kw)
    one = th.solve_refined_batched(t(a), t(b), _gens(range(4)),
                                   torch_cfg(jcfg), device="cpu", **kw)
    assert type(res) is type(one) and res.x.shape == (4, 32)
    for got, want in zip(res, one):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert bool(res.converged.all())
    with jax.enable_x64(True):
        jres = jh.solve_refined_batched_sharded(
            jnp.asarray(a), jnp.asarray(b),
            jax.random.split(jax.random.PRNGKey(0), 4), jcfg,
            mesh=jax_mc_mesh(1), **kw)
        jx, jconv = np.asarray(jres.x), np.asarray(jres.converged)
    scaled_close(res.x, jx, 1e-8)
    assert jconv.all()
    assert tshim.solve_refined_batched_sharded is \
        th.solve_refined_batched_sharded


RANKS = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import hybrid as th
from repro_torch.core import blockamc as tb
from repro_torch.core import distributed as tdist
from repro_torch.core.analog import AnalogConfig, TileGrid
from repro_torch.core.nonideal import NonidealConfig
from repro_torch.launch.mesh import make_mc_mesh

rank = int(os.environ["RANK"])
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1], 4),
                        rank=rank, world_size=4)
mesh = make_mc_mesh(device="cpu")
gens = lambda seeds: [torch.Generator().manual_seed(s) for s in seeds]
rng = np.random.default_rng(3)

def wishart(n):
    x = rng.normal(size=(4 * n, n))
    return torch.from_numpy((x.T @ x / (4 * n)).astype(np.float32))

# test_packed_serving.py:185's case: 8 tenants, n=32, two stages, 8x8
cfg = AnalogConfig(array_size=8, nonideal=NonidealConfig(sigma=0.05))
As = torch.stack([wishart(32) for _ in range(8)])
bs = torch.from_numpy(rng.normal(size=(8, 32, 4)).astype(np.float32))
pp = tb.program_packed(As, gens(range(8)), cfg, 2, device="cpu")
assert torch.equal(tb.execute_arena_packed_sharded(pp, bs, mesh=mesh),
                   tb.execute_arena_packed(pp, bs))
pp6 = tb.program_packed(As[:6], gens(range(6)), cfg, 2, device="cpu")
try:
    tb.execute_arena_packed_sharded(pp6, bs[:6], mesh=mesh)
except ValueError as e:
    assert "divide" in str(e)
else:
    raise SystemExit("divisibility error not raised")
a, b = As[0], bs[0, :, 0]
for mode in ("reference", "fused"):
    assert torch.equal(
        tb.solve_batched_sharded(a, b, gens(range(8)), cfg, 1, mesh=mesh,
                                 mode=mode),
        tb.solve_batched(a, b, gens(range(8)), cfg, 1, mode=mode))
try:
    tb.solve_batched_sharded(a, b, gens(range(6)), cfg, 1, mesh=mesh)
except ValueError as e:
    assert "num_keys=6" in str(e)
else:
    raise SystemExit("divisibility error not raised")
res = th.solve_refined_batched_sharded(
    a, bs[0, :, :2], gens(range(4)), cfg, stages=1, tol=1e-5, maxiter=200,
    use_precond=False, mesh=mesh, device="cpu")
one = th.solve_refined_batched(
    a, bs[0, :, :2], gens(range(4)), cfg, stages=1, tol=1e-5, maxiter=200,
    use_precond=False, device="cpu")
assert all(torch.equal(x, y) for x, y in zip(res, one))

# the tile solver on a 2x2 ("data", "model") mesh against mesh=None: a
# 3x3 tile grid (split unevenly) and a whole two-stage solve
grid = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
gp, gn = (torch.from_numpy(rng.uniform(0, 100e-6, (3, 3, 8, 8))
                           .astype(np.float32)) for _ in range(2))
tiles = TileGrid(gp, gn, torch.tensor(1.0), 100e-6)
v = torch.from_numpy(rng.uniform(-1, 1, 24).astype(np.float32))
want = tdist.mvm_tiled_vec(tiles, v, cfg)
got = tdist.mvm_tiled_vec(tiles, v, cfg, mesh=grid)
assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
a, b = wishart(64), bs[0, :, 0].repeat(2)
want, got = (tdist.solve_distributed(a, b, torch.Generator().manual_seed(1),
                                     cfg, 2, mesh=m, device="cpu")
             for m in (None, grid))
assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
dist.destroy_process_group()
print("OK", rank)
"""


def test_four_gloo_ranks_equal_the_unsharded_calls(tmp_path):
    """Four ranks in subprocesses (a file store; gloo on the loopback
    interface): the packed
    fleet, the Monte-Carlo sweep and the refined sweep split over them
    equal the unsharded calls, an axis that does not divide raises, and
    the tile solver on a 2x2 mesh matches mesh=None."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", RANKS, store],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-4000:]
        assert f"OK {r}" in out


SOLVER_RANKS = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
from repro_torch.core import distributed as tdist
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.nonideal import NonidealConfig

rank = int(os.environ["RANK"])
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1], 4),
                        rank=rank, world_size=4)
x = np.random.default_rng(11).normal(size=(4 * 96, 96))
a = torch.from_numpy((x.T @ x / (4 * 96)).astype(np.float32))
b = torch.from_numpy(np.random.default_rng(12).uniform(-1, 1, 96)
                     .astype(np.float32))
cfg = AnalogConfig(array_size=8, nonideal=NonidealConfig(sigma=0.05))
# (2, 2): every quadrant splits evenly, 3x3 tile grids do not; (4, 1): the
# Schur recursion gathers blocks whose halves do not split over 4 rows
for shape in ((2, 2), (4, 1)):
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    a_split = DTensor.from_local(
        a[mesh.get_local_rank("data") * 96 // shape[0]:][:96 // shape[0],
          mesh.get_local_rank("model") * 96 // shape[1]:][:, :96 // shape[1]],
        mesh, [Shard(0), Shard(1)], run_check=False)
    assert a_split.to_local().numel() * 4 == a.numel()
    plan = tdist.build_dist_plan(a_split, torch.Generator().manual_seed(3),
                                 cfg, 2, device="cpu", mesh=mesh)
    one = tdist.build_dist_plan(a, torch.Generator().manual_seed(3), cfg, 2,
                                device="cpu")
    rows = lambda n: tdist._part(n, mesh, "data")
    cols = lambda n: tdist._part(n, mesh, "model")
    for got, want, exact in ((plan.mvm2[0], one.mvm2[0], True),
                             (plan.mvm3[0], one.mvm3[0], True),
                             (plan.mvm2[1], one.mvm2[1], False),
                             (plan.leaves, one.leaves, False)):
        rt, ct = want.shape[1:3]
        for g, w in ((got.gpos, want.gpos), (got.gneg, want.gneg)):
            w = w[:, rows(rt), cols(ct)]
            assert g.shape == w.shape, (g.shape, w.shape)
            if exact:       # A's own blocks: the same targets, same draws
                assert torch.equal(g, w)
            elif w.numel():     # the Schur products reassociated
                assert float((g - w).abs().max()) <= 1e-5 * float(
                    w.abs().max())
    want = tdist.dist_execute(one, b, cfg)
    got = tdist.dist_execute(plan, b, cfg)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    got = tdist.solve_distributed(a_split, b, torch.Generator().manual_seed(
        3), cfg, 2, mesh=mesh, device="cpu")
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
dist.destroy_process_group()
print("OK", rank)
"""


def test_sharded_tile_solver_holds_a_quarter_of_a_on_each_rank(tmp_path):
    """Four gloo ranks: A split over a ("data", "model") mesh (a quarter on
    each rank) builds a plan whose tiles are the rank's own tiles of the
    unsharded plan drawn from the same generator - level 0's blocks of A
    bit for bit, the Schur complements' to 1e-5 - and solves to the
    unsharded x within 1e-6 of max|x|, on a 2x2 and a 4x1 mesh."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", SOLVER_RANKS, store],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-4000:]
        assert f"OK {r}" in out
