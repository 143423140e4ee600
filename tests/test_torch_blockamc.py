"""The port's compile/execute pipeline (`core/blockamc.py`) against the JAX
package, plus the golden check against a float64 solve.  (The wire model
and write-verify are held against JAX in test_torch_analog.py.)

Programming noise cannot be replayed across frameworks, so:
  * at sigma=0 both packages program the same plan from the same matrix,
    and the recursive executor and the static compile artifacts compare;
  * noisy plans are programmed by JAX and carried across with
    `repro_torch.interop`, then every executor compares on them.

Tolerances (TESTING.md, executor contract):
  * the static schedule, arena layout and whole-schedule program metadata
    are pure Python in both packages: equal exactly;
  * recursive / finalized executors and the conductance stacks: rtol 1e-5
    with atol 1e-6 scaled to the output's magnitude - the same op order,
    only matmul/LAPACK kernels may sum in another order;
  * arena-form paths (explicit inverses from another LAPACK path):
    rtol 2e-4, scaled the same way;
  * the kernel path's layout against the plain path: 1e-5 of max|x| (both
    are f32 reassociations of one computation).
The JAX side runs under jax.jit: one compile per pipeline stage costs far
less than eager dispatch of each small op.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockamc as jb
from repro.core.analog import AnalogConfig as JCfg
from repro.core.nonideal import NonidealConfig as JNi
from repro_torch import interop
from repro_torch.core import blockamc as tb
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.metrics import relative_error
from repro_torch.core.nonideal import NonidealConfig
from _torch_parity import flat_plan_dict, scaled_close, t, torch_cfg

REGIMES = {
    "ideal": dict(),
    "noisy": dict(nonideal=JNi(sigma=0.05), opa_gain=1e4),
    "converters": dict(nonideal=JNi(sigma=0.05), dac_bits=8, adc_bits=8),
}
J_BUILD_FLAT = jax.jit(jb.build_flat_plan, static_argnums=(2, 3))
J_PARTITION = jax.jit(jb.partition_system, static_argnums=(1, 2))
J_PROGRAM = jax.jit(jb.program_system, static_argnums=2)
J_EXECUTE = jax.jit(jb.execute, static_argnums=2)
J_FINALIZE = jax.jit(jb.finalize, static_argnums=1)
J_ARENA = jax.jit(jb.compile_arena)
J_EXEC_FIN = jax.jit(jb.execute_finalized)
J_EXEC_ARENA = jax.jit(partial(jb.execute_arena, use_kernel=False))
CASES = [(9, 8, 0), (17, 8, 1), (17, 8, 2), (16, 4, 2)]    # n, array, stages


def _problem(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4 * n, n))
    a = (x.T @ x / (4 * n)).astype(np.float32)
    b = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    return a, b


def _jax_plan(n, asz, stages, regime, seed=0):
    jcfg = JCfg(array_size=asz, **REGIMES[regime])
    a, b = _problem(n, seed)
    fp = J_BUILD_FLAT(jnp.asarray(a), jax.random.PRNGKey(seed), jcfg, stages)
    return jcfg, fp, a, b


def _targets(node):
    """The partition tree's arrays in a fixed walk order (either package:
    both name the fields a / inv1, a2, a3, inv4s)."""
    if hasattr(node, "a"):
        return [node.a]
    return (_targets(node.inv1) + [node.a2, node.a3]
            + _targets(node.inv4s))


@pytest.mark.parametrize("n,asz,stages", CASES)
def test_sigma0_programming_and_static_artifacts_match_jax(n, asz, stages):
    jcfg = JCfg(array_size=asz, opa_gain=1e4)
    tcfg = torch_cfg(jcfg)
    a, b = _problem(n)
    jparts = J_PARTITION(jnp.asarray(a), jcfg, stages)
    tparts = tb.partition_system(t(a), tcfg, stages)
    assert float(tparts.scale) == float(jparts.scale)
    tt, jt = _targets(tparts.root), _targets(jparts.root)
    assert [tuple(x.shape) for x in tt] == [x.shape for x in jt]
    for x, y in zip(tt, jt):              # Schur complements: LAPACK solves
        scaled_close(x, y, 1e-5)
    jplan = J_PROGRAM(jparts, jax.random.PRNGKey(0), jcfg)
    tplan = tb.program_system(tparts, torch.Generator(), tcfg)
    x = tb.execute(tplan, t(b), tcfg)
    xj = J_EXECUTE(jplan, jnp.asarray(b), jcfg)
    scaled_close(x, xj, 1e-5)

    jfp, tfp = jb.compile_plan(jplan), tb.compile_plan(tplan)
    assert tfp.schedule == jfp.schedule
    assert tfp.inv_keys == jfp.inv_keys and tfp.mvm_keys == jfp.mvm_keys
    for tg, jg in zip(tfp.inv_stacks + tfp.mvm_stacks,
                      jfp.inv_stacks + jfp.mvm_stacks):
        scaled_close(tg.gpos, jg.gpos, 1e-5)
        scaled_close(tg.gneg, jg.gneg, 1e-5)

    jap = J_ARENA(J_FINALIZE(jfp, jcfg))
    tap = tb.compile_arena(tb.finalize(tfp, tcfg))
    for f in ("levels", "out_spec", "arena_size", "n", "in_off",
              "kernel_ok", "num_arrays", "slot_offsets", "slot_ranges",
              "peak_liveness"):
        assert getattr(tap, f) == getattr(jap, f), f
    assert (tap.program is None) == (jap.program is None)
    if tap.program is not None:
        for tm, jm in zip(tap.program[1:], jap.program[1:]):
            assert tm.numpy().dtype == np.asarray(jm).dtype
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        scaled_close(tap.program[0], jap.program[0], 2e-4)
    for ts, js in zip(tap.stacks, jap.stacks):
        scaled_close(ts, js, 2e-4)


@pytest.mark.parametrize(
    "n,asz,stages,regime",
    [c + ("noisy",) for c in CASES]
    + [(17, 8, 2, "ideal"), (16, 4, 2, "converters")])
def test_executors_match_jax_on_carried_plans(n, asz, stages, regime):
    jcfg, jfp, _, b = _jax_plan(n, asz, stages, regime)
    tcfg = torch_cfg(jcfg)
    solver = interop.solver_from_numpy(flat_plan_dict(jfp), tcfg,
                                       device="cpu")
    jfin = J_FINALIZE(jfp, jcfg)
    jap = J_ARENA(jfin)
    x_fin = solver.solve(t(b), mode="reference")
    x_ar = tb.execute_arena(solver.arena, t(b), use_kernel=False)
    scaled_close(x_fin, J_EXEC_FIN(jfin, jnp.asarray(b)), 1e-5)
    scaled_close(x_ar, J_EXEC_ARENA(jap, jnp.asarray(b)), 2e-4)
    # a single (n,) rhs is column 0 of the batch, in both executors
    for mode, x in (("reference", x_fin), ("fused", x_ar)):
        scaled_close(solver.solve(t(b[:, 0]), mode=mode), x[:, 0], 1e-6)


@pytest.mark.parametrize("stages", [0, 1, 2])
@pytest.mark.parametrize("n", [8, 17, 64])
def test_ideal_matches_float64_solve(n, stages):
    """Golden: with ideal converters, devices and OPAs every executor
    reproduces a float64 solve to 1e-4 (paper metric, f32 arithmetic), as
    tests/test_golden_regression.py pins the JAX package."""
    cfg = AnalogConfig(array_size=8)
    a, b = _problem(n, seed=7)
    x_ref = torch.linalg.solve(t(a, torch.float64), t(b, torch.float64))
    gen = torch.Generator().manual_seed(7)
    plan = tb.build_plan(t(a), gen, cfg, stages)
    solver = tb.ProgrammedSolver.from_plan(plan, cfg)
    for x in (tb.execute(plan, t(b), cfg), solver.solve(t(b)),
              solver.solve(t(b), mode="reference")):
        err = relative_error(x_ref.T, x.double().T)
        assert float(err.max()) < 1e-4


@pytest.mark.parametrize("n,asz,stages,uniform", [(16, 4, 2, True),
                                                  (17, 8, 1, False),
                                                  (64, 16, 2, True)])
def test_kernel_layout_on_host_matches_plain_path(n, asz, stages, uniform):
    """use_kernel=True on CPU tensors runs the kernel path's physical arena
    and metadata through the kernel's plain version: the whole-program
    call for uniform plans, per-level groups otherwise."""
    cfg = AnalogConfig(array_size=asz, nonideal=NonidealConfig(sigma=0.05),
                       opa_gain=1e4)
    a, b = _problem(n, seed=3)
    solver = tb.ProgrammedSolver.program(
        a, torch.Generator().manual_seed(3), cfg, stages, device="cpu")
    ap = solver.arena
    assert ap.kernel_ok and (ap.program is not None) == uniform
    for bb in (t(b), t(b[:, 0])):
        scaled_close(tb.execute_arena(ap, bb, use_kernel=True),
                     tb.execute_arena(ap, bb, use_kernel=False), 1e-5)


def test_ragged_plan_stays_on_plain_path():
    cfg = AnalogConfig(array_size=8)
    a, b = _problem(5)
    solver = tb.ProgrammedSolver.program(a, torch.Generator(), cfg, 2,
                                         device="cpu")
    assert not solver.arena.kernel_ok
    with pytest.raises(ValueError, match="ragged"):
        tb.execute_arena(solver.arena, t(b), use_kernel=True)
    x_ref = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    scaled_close(solver.solve(t(b)), x_ref, 1e-4)


def test_solve_many_pads_to_pow2_and_slices_back():
    cfg = AnalogConfig(array_size=8, nonideal=NonidealConfig(sigma=0.05))
    a, b = _problem(16)
    solver = tb.ProgrammedSolver.program(a, torch.Generator(), cfg,
                                         device="cpu")
    xs = solver.solve_many(t(b))
    assert xs.shape == (16, 3)
    scaled_close(xs, solver.solve(t(b)), 1e-6)
    assert solver.solve_many(torch.zeros(16, 0)).shape == (16, 0)
    for k in (0, 1, 3, 4, 5):
        bs = torch.ones(2, 4, k)
        out, kk = tb.pad_rhs_pow2(bs)
        ref, kj = jb.pad_rhs_pow2(jnp.ones((2, 4, k)))
        assert kk == kj == k and tuple(out.shape) == ref.shape


def test_plan_signature_matches_jax_structure():
    jcfg = JCfg(array_size=8)
    for n, stages in [(17, None), (16, 2), (64, 1)]:
        sj = jb.plan_signature(n, stages, jcfg)
        st = tb.plan_signature(n, stages, torch_cfg(jcfg))
        assert st[:4] == sj[:4]


def test_cuda_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the request would succeed")
    a, _ = _problem(8)
    with pytest.raises(RuntimeError, match="cuda"):
        tb.ProgrammedSolver.program(a, torch.Generator(), AnalogConfig())


def test_finalize_factors_a_singular_array_like_the_reference():
    """A stuck-at fault can zero an INV array's differential conductance.
    The reference factors it anyway (its solves turn non-finite, and the
    serving canary quarantines the matrix); the port must not raise in
    `finalize` there, on the whole plan or on a repaired slice."""
    cfg = JCfg(array_size=8, nonideal=JNi(sigma=0.02))
    rng = np.random.default_rng(4)
    g = rng.normal(size=(16, 16))
    a = (g @ g.T / 16 + np.eye(16)).astype(np.float32)
    js = jb.ProgrammedSolver.program(jnp.asarray(a), jax.random.PRNGKey(2),
                                     cfg, 1)
    leaves, treedef = jax.tree_util.tree_flatten(js.flat)
    dead = js.flat.inv_stacks[0]
    i = next(k for k, x in enumerate(leaves) if x is dead.gneg)
    leaves[i] = dead.gneg.at[0].set(dead.gpos[0])      # G+ - G- = 0
    jfp = jax.tree_util.tree_unflatten(treedef, leaves)
    jx = np.asarray(jb.execute_finalized(jb.finalize(jfp, cfg),
                                         jnp.ones(16)))
    d = flat_plan_dict(js.flat)
    gp, gn = d["inv_stacks"][0]
    gn = gn.copy()
    gn[0] = gp[0]
    d["inv_stacks"][0] = (gp, gn)
    tcfg = torch_cfg(cfg)
    fin = tb.finalize(interop.flat_plan_from_numpy(d, device="cpu"), tcfg)
    tx = tb.execute_finalized(fin, torch.ones(16)).numpy()
    assert not np.all(np.isfinite(jx)) and not np.all(np.isfinite(tx))
    solver = tb.ProgrammedSolver(fin)
    assert not bool(torch.isfinite(solver.solve(torch.ones(16))).all())
