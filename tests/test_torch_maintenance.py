"""The life of a programmed plan after programming, in the port: per-array
ages (`PlanAges`, `ProgrammedSolver.aged`), the block map and block repair
(`plan_block_map`, `repair_blocks`, `splice_finalized`, `splice_arena`,
`ProgrammedSolver.repaired`), `pack_partitioned` / `build_flat_plan`, the
service's `refresh`, and `repro_torch.serve.maintenance` - against the JAX
package, and against the port's own repair contracts.

Noise cannot be replayed across frameworks: plans JAX programmed are
carried across with `repro_torch.interop` (with their partitioned system
and stage count, so the port can age and repair them); repair against the
reference runs at sigma 0, where re-programming a block draws nothing.

Tolerances (TESTING.md, executor contract): the block map is pure Python
and equal exactly; conductances and finalized answers rtol 1e-5 scaled to
the output's magnitude (1e-6 floor); arena-form answers and stacks rtol
2e-4; maintenance probes rtol 1e-5; the port's repair contracts (the
reference's tests/test_block_repair.py) bit for bit on the CPU, under one
generator: repairing every block equals `program` at the same seed at all
three plan levels, a subset takes exactly the full re-program's slices
and leaves the others as they were, and the spliced plans equal a fresh
`finalize` / `compile_arena` of the spliced flat plan.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockamc as jb
from repro.core.analog import AnalogConfig as JCfg
from repro.core.nonideal import NonidealConfig as JNi
from repro.serve import maintenance as jmaint
from repro_torch import interop
from repro_torch.core import blockamc as tb
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.nonideal import NonidealConfig
from repro_torch.serve import SolverService
from repro_torch.serve import maintenance as tmaint
from _torch_parity import (flat_plan_dict, scaled_close, solver_dict, t,
                           torch_cfg)

DRIFT_CFG = JCfg(array_size=4, nonideal=JNi(sigma=0.05, drift_nu=0.05),
                 opa_gain=1e4)
N, STAGES = 16, 2          # uniform plan: 10 arrays, 23 tiles of 4x4


def _wishart(n, seed):
    x = np.random.default_rng(seed).normal(size=(4 * n, n))
    return (x.T @ x / (4 * n)).astype(np.float32)


def _jax_solver(jcfg, n=N, stages=STAGES, seed=0):
    return jb.ProgrammedSolver.program(jnp.asarray(_wishart(n, seed)),
                                       jax.random.PRNGKey(seed), jcfg,
                                       stages)


def _carried(js, jcfg):
    return interop.solver_from_numpy(solver_dict(js), torch_cfg(jcfg),
                                     device="cpu")


def _rhs(n=N, k=3, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, size=(n, k)).astype(
        np.float32)


# ----------------------------- the block map ------------------------------

@pytest.mark.parametrize("n,stages,asz", [(16, 1, 8), (16, 2, 8),
                                          (17, 2, 8), (64, 2, 16)])
def test_plan_block_map_matches_jax(n, stages, asz):
    def rows(recs):
        return [(r.kind, r.bucket, r.index, r.depth, tuple(r.shape), r.path)
                for r in recs]
    jcfg = JCfg(array_size=asz)
    recs = tb.plan_block_map(n, stages, torch_cfg(jcfg))
    assert rows(recs) == rows(jb.plan_block_map(n, stages, jcfg))
    # it addresses the port's own plan: every array once, at its shape
    fplan = tb.build_flat_plan(torch.from_numpy(_wishart(n, 0)),
                               torch.Generator(), torch_cfg(jcfg), stages)
    assert len(recs) == fplan.num_arrays == len({r.ref for r in recs})
    for r in recs:
        stacks = fplan.inv_stacks if r.kind == "inv" else fplan.mvm_stacks
        assert stacks[r.bucket].shape[-2:] == r.shape
        assert r.index < stacks[r.bucket].shape[-3]


def test_build_flat_plan_and_pack_partitioned_match_jax():
    jcfg = JCfg(array_size=8, opa_gain=1e4)
    tcfg = torch_cfg(jcfg)
    mats = [_wishart(16, s) for s in range(3)]
    jfp = jb.build_flat_plan(jnp.asarray(mats[0]), jax.random.PRNGKey(0),
                             jcfg, 1)
    tfp = tb.build_flat_plan(torch.from_numpy(mats[0]), torch.Generator(),
                             tcfg, 1)
    assert tfp.schedule == jfp.schedule
    for tg, jg in zip(tfp.inv_stacks + tfp.mvm_stacks,
                      jfp.inv_stacks + jfp.mvm_stacks):
        scaled_close(tg.gpos, jg.gpos, 1e-5)
        scaled_close(tg.gneg, jg.gneg, 1e-5)
    jpk = jb.pack_partitioned([jb.partition_system(jnp.asarray(a), jcfg, 2)
                               for a in mats])
    tpk = tb.pack_partitioned([tb.partition_system(torch.from_numpy(a),
                                                   tcfg, 2) for a in mats])
    jleaves, tleaves = jax.tree_util.tree_leaves(jpk), []

    def walk(node):
        if isinstance(node, tb.LeafTarget):
            tleaves.append(node.a)
        else:
            walk(node.inv1)
            tleaves.extend([node.a2, node.a3])
            walk(node.inv4s)
    walk(tpk.root)
    tleaves.append(tpk.scale)
    assert [tuple(x.shape) for x in tleaves] == [x.shape for x in jleaves]
    for x, y in zip(tleaves, jleaves):
        scaled_close(x, y, 1e-5)
    other = tb.partition_system(torch.from_numpy(_wishart(17, 0)), tcfg, 2)
    with pytest.raises(ValueError, match="not stackable"):
        tb.pack_partitioned([tb.partition_system(torch.from_numpy(mats[0]),
                                                 tcfg, 2), other])


# --------------------------------- ages -----------------------------------

@pytest.mark.parametrize("ages", ["vector", "scalar"])
def test_aged_matches_jax(ages):
    js = _jax_solver(DRIFT_CFG)
    ts = _carried(js, DRIFT_CFG)
    assert ts.ageable and ts.repairable and ts.num_arrays == js.num_arrays
    rng = np.random.default_rng(2)
    fp = js.flat
    if ages == "vector":
        d = {k: [rng.uniform(1.0, 1e4, size=g.gpos.shape[0]).astype(
            np.float32) for g in stacks]
             for k, stacks in (("inv", fp.inv_stacks),
                               ("mvm", fp.mvm_stacks))}
        j_age = jb.PlanAges(tuple(jnp.asarray(x) for x in d["inv"]),
                            tuple(jnp.asarray(x) for x in d["mvm"]))
        t_age = interop.plan_ages_from_numpy(d, device="cpu")
    else:
        j_age = t_age = 300.0
    b = _rhs()
    jaged, taged = js.aged(j_age), ts.aged(t_age)
    assert taged.repairable and taged.flat is ts.flat
    scaled_close(taged.solve(t(b), mode="reference"),
                 jaged.solve(jnp.asarray(b), mode="reference"), 1e-5)
    scaled_close(taged.solve(t(b)), jaged.solve(jnp.asarray(b)), 2e-4)
    # the ages moved the answers: drift is on
    assert not np.allclose(taged.solve(t(b)).numpy(),
                           ts.solve(t(b)).numpy(), rtol=1e-4)
    if ages == "scalar":
        # a uniform PlanAges is the scalar age, bit for bit
        u = tb.uniform_ages(ts.flat, 300.0)
        ju = jb.uniform_ages(fp, 300.0)
        assert [tuple(x.shape) for x in u.inv + u.mvm] == \
            [x.shape for x in ju.inv + ju.mvm]
        assert torch.equal(ts.aged(u).solve(t(b)), taged.solve(t(b)))


# ----------------------- block repair vs the reference --------------------

@pytest.mark.parametrize("stages", [1, 2])
def test_repair_matches_jax_at_sigma0(stages):
    """A noisy plan JAX programmed, carried across and repaired in both
    packages under a sigma-0 config with write-verify (re-programming a
    block draws nothing): the same repaired plan."""
    noisy = JCfg(array_size=8, opa_gain=1e4, nonideal=JNi(
        sigma=0.05, r_wire=1.0, compensate_wire=True, wv_iters=2))
    clean = noisy.with_(nonideal=dataclasses.replace(noisy.nonideal,
                                                     sigma=0.0))
    js = _jax_solver(noisy, stages=stages, seed=3)
    js0 = jb.ProgrammedSolver.from_plan(js.flat, clean, parts=js._parts,
                                        stages=js.stages)
    ts0 = _carried(js, clean)
    refs = [r.ref for r in js0.block_map()]
    assert [r.ref for r in ts0.block_map()] == refs
    subset = refs[::2]
    jrep = js0.repaired(subset, jax.random.PRNGKey(9))
    trep = ts0.repaired(subset, torch.Generator().manual_seed(9))
    for tg, jg in zip(trep.flat.inv_stacks + trep.flat.mvm_stacks,
                      jrep.flat.inv_stacks + jrep.flat.mvm_stacks):
        scaled_close(tg.gpos, jg.gpos, 1e-5)
        scaled_close(tg.gneg, jg.gneg, 1e-5)
    for ts_, js_ in zip(trep.arena.stacks, jrep.arena.stacks):
        scaled_close(ts_, js_, 2e-4)
    b = _rhs(16, seed=4)
    scaled_close(trep.solve(t(b), mode="reference"),
                 jrep.solve(jnp.asarray(b), mode="reference"), 1e-5)
    scaled_close(trep.solve(t(b)), jrep.solve(jnp.asarray(b)), 2e-4)


# ------------------------ the port's repair contracts ---------------------

NONIDEAL = {
    "sigma": NonidealConfig(sigma=0.05),
    "wire": NonidealConfig(sigma=0.02, r_wire=1.0, wire_model="first_order",
                           compensate_wire=True, wv_iters=2),
    "faults": NonidealConfig(sigma=0.02, p_stuck_off=0.05, g_stuck_off=0.0,
                             remap_faults=True),
}


def _program(cfg, stages, seed):
    return tb.ProgrammedSolver.program(
        torch.from_numpy(_wishart(16, 11)),
        torch.Generator().manual_seed(seed), cfg, stages, device="cpu")


def _assert_grids_equal(g1, g2):
    assert len(g1) == len(g2)
    for x, y in zip(g1, g2):
        assert torch.equal(x.gpos, y.gpos) and torch.equal(x.gneg, y.gneg)


def _assert_fin_equal(f1, f2):
    for (lu1, p1), (lu2, p2) in zip(f1.lu_stacks, f2.lu_stacks):
        assert torch.equal(lu1, lu2) and torch.equal(p1, p2)
    assert len(f1.mvm_levels) == len(f2.mvm_levels)
    for l1, l2 in zip(f1.mvm_levels, f2.mvm_levels):
        assert len(l1.stacks) == len(l2.stacks)
        for x, y in zip(l1.stacks + l1.divs, l2.stacks + l2.divs):
            assert torch.equal(x, y)


def _assert_arena_equal(a1, a2):
    assert len(a1.stacks) == len(a2.stacks)
    for x, y in zip(a1.stacks, a2.stacks):
        assert torch.equal(x, y)
    assert (a1.program is None) == (a2.program is None)
    if a1.program is not None:
        assert torch.equal(a1.program[0], a2.program[0])


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("variant", sorted(NONIDEAL))
def test_repair_equivalence(variant, stages):
    cfg = AnalogConfig(array_size=8, nonideal=NONIDEAL[variant],
                       opa_gain=1e4)
    old = _program(cfg, stages, 1)
    ref = _program(cfg, stages, 2)
    refs = [r.ref for r in old.block_map()]
    assert len(refs) == old.flat.num_arrays

    # 1. every block under a generator seeded 2 == program under seed 2
    full = old.repaired(refs, torch.Generator().manual_seed(2))
    _assert_grids_equal(full.flat.inv_stacks, ref.flat.inv_stacks)
    _assert_grids_equal(full.flat.mvm_stacks, ref.flat.mvm_stacks)
    _assert_fin_equal(full.finalized, ref.finalized)
    _assert_arena_equal(full.arena, ref.arena)

    # 2. a strict subset takes the full re-program's slices; the others
    #    stay the original's
    subset = [refs[i] for i in sorted(np.random.default_rng(0).choice(
        len(refs), size=max(1, len(refs) // 3), replace=False))]
    part = old.repaired(subset, torch.Generator().manual_seed(2))
    chosen = set(subset)
    for kind in ("inv", "mvm"):
        got = getattr(part.flat, f"{kind}_stacks")
        for b, grid in enumerate(got):
            for i in range(grid.gpos.shape[0]):
                src = ref if (kind, b, i) in chosen else old
                want = getattr(src.flat, f"{kind}_stacks")[b]
                assert torch.equal(grid.gpos[i], want.gpos[i])
                assert torch.equal(grid.gneg[i], want.gneg[i])
    # the old solver is untouched
    _assert_grids_equal(old.flat.mvm_stacks,
                        _program(cfg, stages, 1).flat.mvm_stacks)

    # 3. the splices equal a from-scratch finalize / compile of the
    #    spliced flat plan
    refin = tb.finalize(part.flat, cfg)
    _assert_fin_equal(part.finalized, refin)
    _assert_arena_equal(part.arena, tb.compile_arena(refin))


def test_repair_refuses_unknown_blocks_and_bare_solvers():
    cfg = AnalogConfig(array_size=8, nonideal=NONIDEAL["sigma"])
    solver = _program(cfg, 1, 0)
    with pytest.raises(KeyError):
        solver.repaired([("inv", 99, 0)], torch.Generator())
    bare = tb.ProgrammedSolver(solver.finalized, solver.arena)
    assert not bare.repairable and not bare.ageable
    with pytest.raises(ValueError):
        bare.repaired([("inv", 0, 0)], torch.Generator())
    with pytest.raises(ValueError):
        bare.aged(10.0)
    with pytest.raises(ValueError):
        bare.block_map()


# ------------------------------ the service -------------------------------

def test_refresh_keeps_bookkeeping_and_drops_the_cached_pack():
    tcfg = torch_cfg(DRIFT_CFG)
    svc = SolverService(tcfg, stages=STAGES, device="cpu")
    for i, mid in enumerate(("a", "b")):
        svc.program(mid, _wishart(N, i), torch.Generator().manual_seed(i))
    b = _rhs(k=2)
    for mid in ("a", "b"):
        for j in range(2):
            svc.submit(mid, b[:, j])
    svc.flush_all()
    assert any("a" in ids for ids, _ in svc._packs.values())
    stats = dataclasses.replace(svc.stats("a"))
    sig, dense = svc.signature("a"), svc.dense("a")
    assert svc.matrix_cfg("a") == tcfg and sig == tb.plan_signature(
        N, STAGES, tcfg)
    svc.submit("a", b[:, 0])                 # pending across the refresh
    aged = svc.solver("a").aged(500.0)
    svc.refresh("a", aged)
    assert svc.solver("a") is aged
    assert not any("a" in ids for ids, _ in svc._packs.values())
    assert svc.stats("a") == stats and svc.pending("a") == 1
    assert svc.signature("a") == sig and svc.dense("a") is dense
    out = svc.flush_all()
    scaled_close(out["a"][:, 0], aged.solve(t(b[:, 0])), 1e-6)
    with pytest.raises(KeyError):
        svc.refresh("nope", aged)
    small = tb.ProgrammedSolver.program(_wishart(8, 0), torch.Generator(),
                                        tcfg, 1, device="cpu")
    with pytest.raises(ValueError, match="changed n"):
        svc.refresh("a", small)


# ------------------------------ maintenance -------------------------------

def test_device_clock_and_block_trend_match_jax():
    clocks = (jmaint.DeviceClock(), tmaint.DeviceClock())
    seen = []
    for c in clocks:
        c.subscribe(lambda c=c: seen.append(c.now()))
    for dt in (0.5, 0.0, 2.25):
        assert clocks[1].advance(dt) == clocks[0].advance(dt)
    assert seen[0::2] == seen[1::2] and len(seen) == 6
    for c in clocks:
        with pytest.raises(ValueError):
            c.advance(-1.0)
    obs = [(0.0, 0.001), (1.0, 0.004), (1.0, 0.5), (2.5, 0.009),
           (4.0, 0.008), (6.0, 0.02)]
    for alpha in (0.5, 0.2):
        jt, tt = jmaint.BlockTrend(alpha), tmaint.BlockTrend(alpha)
        for when, dev in obs:
            jt.observe(when, dev)
            tt.observe(when, dev)
            for slot in jmaint.BlockTrend.__slots__:
                assert getattr(tt, slot) == getattr(jt, slot), slot
            assert tt.ready(2) == jt.ready(2)
            for trip in (0.005, 0.05):
                assert tt.time_to_trip(trip) == jt.time_to_trip(trip)


def test_matrix_maintenance_matches_jax():
    js = _jax_solver(DRIFT_CFG, seed=5)
    ts = _carried(js, DRIFT_CFG)
    mcfg = dict(scrub_blocks_per_cycle=4, block_trip=0.02, repair_lead=0.5)
    jm = jmaint.MatrixMaintenance(js, jmaint.MaintenanceConfig(**mcfg), 0.0)
    tm = tmaint.MatrixMaintenance(ts, tmaint.MaintenanceConfig(**mcfg), 0.0)
    assert tm.refs == jm.refs
    jcfg, tcfg = js.cfg, ts.cfg
    for now in (0.5, 1.0, 3.0):
        for ref in jm.refs:
            np.testing.assert_allclose(
                tm.probe(ts.flat, tcfg, ref, now),
                jm.probe(js.flat, jcfg, ref, now), rtol=1e-5)
        for jx, tx in zip(jm.plan_ages(js.flat, now).inv
                          + jm.plan_ages(js.flat, now).mvm,
                          tm.plan_ages(ts.flat, now).inv
                          + tm.plan_ages(ts.flat, now).mvm):
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        while jm.backlog(now):
            assert tm.scrub(ts.flat, tcfg, now, 4) == \
                jm.scrub(js.flat, jcfg, now, 4)
            assert tm.pending == jm.pending
        assert tm.backlog(now) == 0
    assert tm.pending, "the drift should have scheduled repairs"
    jg, tg = jm.gauges(3.0), tm.gauges(3.0)
    assert sorted(tg) == sorted(jg)
    for key in jg:
        np.testing.assert_allclose(tg[key], jg[key], rtol=1e-5)
    # a repair resets the repaired arrays' bookkeeping
    blocks = sorted(tm.pending)[:2]
    rep = ts.repaired(blocks, torch.Generator().manual_seed(0))
    tm.note_repaired(blocks, rep.flat, rep.cfg, 3.0)
    assert not (set(blocks) & tm.pending) and tm.blocks_repaired == 2
    assert all(tm.age(ref, 3.0) == 1.0 and tm.trends[ref].probes == 0
               for ref in blocks)
    assert tm.probe(rep.flat, tcfg, blocks[0], 3.0) < 1e-6
