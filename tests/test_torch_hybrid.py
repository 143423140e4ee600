"""The port's hybrid analog-digital layer (`repro_torch.hybrid`) and the
service's refined paths against the JAX package.

The Krylov solvers get the same float64 operators and right-hand sides in
both packages (JAX under `jax.enable_x64`, called directly: the JAX
package's own Krylov tests fail at import on this jax).  The analog
preconditioners are plans JAX programmed, carried across with
`repro_torch.interop` (programming noise cannot be replayed).

Tolerances:
  * iteration counts equal, or within one where the stopping test lies
    within rounding of tol (the two packages sum dot products in another
    order, so a residual at tol*(1 +- 1e-12) may stop on either side);
    GMRES counts restart cycles and must match exactly;
  * float64 answers within 1e-8 of max|x| (both meet tol=1e-10 on
    systems of condition <= 1e4); preconditioner applications within
    1e-10 of max|out| (the same float64 cascade, matmuls reassociated);
  * gradients within 1e-6 of max|grad| (forward and adjoint solves each
    converge to 1e-10 relative residual);
  * the float32 service against the JAX service: answers within 1e-4 of
    max|x| (both stop at tol=1e-6) and Krylov iteration totals within one
    per right-hand side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import hybrid as jh
from repro.core import blockamc as jb
from repro.core.analog import AnalogConfig as JCfg
from repro.core.nonideal import NonidealConfig as JNi
from repro.serve import SolverService as JService
from repro_torch import hybrid as th
from repro_torch import interop
from repro_torch.core import blockamc as tb
from repro_torch.hybrid import krylov as tkrylov
from repro_torch.hybrid import refine as trefine
from repro_torch.serve import SolverService
from _torch_parity import flat_plan_dict, scaled_close, t, torch_cfg

N = 64
CG_CFG = JCfg(array_size=N // 2, opa_gain=1e5)
GMRES_CFG = JCfg(array_size=N // 2, nonideal=JNi(sigma=1e-4, r_wire=1.0,
                                                 compensate_wire=True))


def _spd_with_cond(n, cond, seed):
    """A Wishart draw's eigenvectors with a log-uniform spectrum 1..1/cond
    (float64 numpy)."""
    x = np.random.default_rng(seed).normal(size=(4 * n, n))
    _, v = np.linalg.eigh(x.T @ x / (4 * n))
    return (v * np.logspace(0.0, -np.log10(cond), n)) @ v.T


def _rhs(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape)


def _iters_close(ours, theirs, slack=1):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert np.all(np.abs(ours.astype(int) - theirs.astype(int)) <= slack), \
        (ours, theirs)


def _preconds(a, jcfg, stages=1, seed=3):
    """A JAX-programmed float64 preconditioner (under x64) and the port's
    on the same carried conductances, both fused (arena executor)."""
    jfp = jb.compile_plan(jb.build_plan(jnp.asarray(a),
                                        jax.random.PRNGKey(seed), jcfg,
                                        stages))
    jprec = jh.AnalogPreconditioner(jb.finalize(jfp, jcfg))
    tcfg = torch_cfg(jcfg)
    tfp = interop.flat_plan_from_numpy(flat_plan_dict(jfp), device="cpu")
    tprec = th.AnalogPreconditioner(tb.finalize(tfp, tcfg))
    return jprec, tprec


# ------------------------------ solvers -----------------------------------

@pytest.mark.parametrize("method,jcfg", [("cg", CG_CFG),
                                         ("gmres", GMRES_CFG)])
def test_preconditioned_krylov_matches_jax(method, jcfg):
    """The hybrid benchmark's headline configuration (n=64, cond 1e4):
    preconditioned CG (ideal devices, finite OPA gain) and GMRES
    (sigma=1e-4, compensated 1 ohm wires) from the analog seed."""
    a = _spd_with_cond(N, 1e4, 0)
    b = _rhs((2, N), 1)
    with jax.enable_x64(True):
        jprec, tprec = _preconds(a, jcfg)
        assert tprec.compute_dtype == torch.float64
        scaled_close(tprec(t(b)), jprec(jnp.asarray(b)), 1e-10)
        jmv = jh.matvec_from_dense(jnp.asarray(a))
        tmv = th.matvec_from_dense(t(a))
        kw = dict(tol=1e-10, maxiter=4000)
        if method == "cg":
            want = jh.pcg(jmv, jnp.asarray(b), precond=jprec,
                          x0=jprec(jnp.asarray(b)), **kw)
            got = th.pcg(tmv, t(b), precond=tprec, x0=tprec(t(b)), **kw)
            _iters_close(got.iters, want.iters)
        else:
            want = jh.gmres(jmv, jnp.asarray(b), precond=jprec,
                            x0=jprec(jnp.asarray(b)), restart=16, **kw)
            got = th.gmres(tmv, t(b), precond=tprec, x0=tprec(t(b)),
                           restart=16, **kw)
            _iters_close(got.iters, want.iters, slack=0)
        plain = jh.pcg(jmv, jnp.asarray(b), **kw)
    assert bool(got.converged.all()) and bool(want.converged.all())
    assert got.iters.dtype == torch.int32
    assert float(got.resnorm.max()) <= 1e-10
    scaled_close(got.x, want.x, 1e-8)
    # the analog preconditioner saves digital iterations here
    assert int(got.iters.max()) * 2 < int(np.asarray(plain.iters).min())


def test_pcg_and_gmres_unpreconditioned_match_jax():
    a = _spd_with_cond(48, 1e3, 5)
    b = _rhs((3, 48), 6)
    with jax.enable_x64(True):
        jmv = jh.matvec_from_dense(jnp.asarray(a))
        for fn, kw in ((jh.pcg, {}), (jh.gmres, dict(restart=8))):
            want = fn(jmv, jnp.asarray(b), tol=1e-10, maxiter=2000, **kw)
            got = getattr(th, fn.__name__)(th.matvec_from_dense(t(a)), t(b),
                                           tol=1e-10, maxiter=2000, **kw)
            _iters_close(got.iters, want.iters,
                         slack=1 if fn is jh.pcg else 0)
            scaled_close(got.x, want.x, 1e-8)
            assert np.array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))


def test_pcg_fixed_matches_jax_and_pcg_budget():
    a = _spd_with_cond(24, 1e3, 7)
    bt = np.stack([_rhs(24, 8), np.zeros(24)])
    with jax.enable_x64(True):
        want = jh.pcg_fixed(jh.matvec_from_dense(jnp.asarray(a)),
                            jnp.asarray(bt), iters=7)
    mv = th.matvec_from_dense(t(a))
    got = th.pcg_fixed(mv, t(bt), iters=7)
    scaled_close(got.x, want.x, 1e-10)
    scaled_close(got.resnorm, want.resnorm, 1e-10)
    assert torch.all(got.x[1] == 0.0)          # zero rhs: a fixed point
    assert got.iters.tolist() == [7, 7]
    budget = th.pcg(mv, t(bt), tol=0.0, maxiter=7)
    scaled_close(got.x, budget.x, 1e-12)


def test_pcg_fixed_preconditioned_matches_jax():
    """Three fixed steps with the headline CG preconditioner, from the
    analog seed, on a JAX-programmed plan carried across (float64)."""
    a = _spd_with_cond(N, 1e4, 0)
    b = _rhs((2, N), 1)
    with jax.enable_x64(True):
        jprec, tprec = _preconds(a, CG_CFG)
        want = jh.pcg_fixed(jh.matvec_from_dense(jnp.asarray(a)),
                            jnp.asarray(b), precond=jprec,
                            x0=jprec(jnp.asarray(b)), iters=3, tol=1e-10)
    got = th.pcg_fixed(th.matvec_from_dense(t(a)), t(b), precond=tprec,
                       x0=tprec(t(b)), iters=3, tol=1e-10)
    scaled_close(got.x, want.x, 1e-8)
    # a residual of ~1e-8 of ||b|| is a difference of nearly equal numbers:
    # the answers' float64 rounding, times cond 1e4, shows at ~1e-4 of it
    scaled_close(got.resnorm, want.resnorm, 1e-4)
    assert np.array_equal(got.converged.numpy(), np.asarray(want.converged))


def test_masks_freeze_converged_columns_bit_for_bit():
    """A zero rhs never updates, an eigenvector converges in one step, a
    generic rhs takes longer; once a column stops, more iterations of the
    others leave it bit-identical, and its count equals its solo run's."""
    n = 32
    a = _spd_with_cond(n, 1e2, 9)
    _, evecs = np.linalg.eigh(a)
    bt = t(np.stack([np.zeros(n), evecs[:, -1], _rhs(n, 10)]))
    mv = th.matvec_from_dense(t(a))
    res = th.pcg(mv, bt, tol=1e-8, maxiter=500)
    assert res.iters[0] == 0 and bool(torch.all(res.x[0] == 0.0))
    assert int(res.iters[1]) < int(res.iters[2])
    assert bool(res.converged.all())
    early = th.pcg(mv, bt, tol=1e-8, maxiter=int(res.iters[1]))
    assert torch.equal(early.x[1], res.x[1])
    solo = th.pcg(mv, bt[1], tol=1e-8, maxiter=500)
    assert int(solo.iters) == int(res.iters[1])
    with jax.enable_x64(True):
        want = jh.pcg(jh.matvec_from_dense(jnp.asarray(a)),
                      jnp.asarray(bt.numpy()), tol=1e-8, maxiter=500)
    _iters_close(res.iters, want.iters)


def test_true_exit_residual_is_reported():
    """At f32 x cond 1e6 the recurrence residual shrinks past the true one;
    pcg and gmres report the true exit residual and never over-report
    convergence."""
    n = 48
    a = t(_spd_with_cond(n, 1e6, 11), torch.float32)
    bt = t(_rhs((2, n), 12), torch.float32)
    tol = 1e-6
    mv = th.matvec_from_dense(a)
    for res in (th.pcg(mv, bt, tol=tol, maxiter=3000),
                th.gmres(mv, bt, tol=tol, restart=5, maxiter=35)):
        r = bt.double() - res.x.double() @ a.double().T
        ext = (r.norm(dim=-1) / bt.double().norm(dim=-1)).numpy()
        np.testing.assert_allclose(res.resnorm.numpy(), ext, rtol=1e-2)
        for c, e in zip(res.converged.tolist(), ext):
            assert (not c) or e <= tol * 1.0001
    assert float(ext.max()) > tol               # the stagnating regime


def test_loop_reads_one_flag_per_iteration():
    a = _spd_with_cond(16, 10.0, 13)
    before = tkrylov.any_active.reads
    res = th.pcg(th.matvec_from_dense(t(a)), t(_rhs(16, 14)), tol=1e-10,
                 maxiter=200)
    assert tkrylov.any_active.reads - before == int(res.iters) + 1
    before = tkrylov.any_active.reads
    th.pcg(th.matvec_from_dense(t(a)), t(_rhs(16, 14)), tol=1e-10,
           maxiter=3)
    assert tkrylov.any_active.reads - before == 3


# --------------------------- preconditioner -------------------------------

@pytest.mark.parametrize("mode", ["fused", "reference"])
def test_preconditioner_over_leading_axes_matches_jax(mode):
    a = _spd_with_cond(N, 1e2, 15).astype(np.float32)
    jcfg = JCfg(array_size=16, nonideal=JNi(sigma=0.05))
    jfp = jb.compile_plan(jb.build_plan(jnp.asarray(a),
                                        jax.random.PRNGKey(4), jcfg, 2))
    jprec = jh.AnalogPreconditioner(jb.finalize(jfp, jcfg), mode=mode)
    tprec = th.AnalogPreconditioner(tb.finalize(
        interop.flat_plan_from_numpy(flat_plan_dict(jfp), device="cpu"),
        torch_cfg(jcfg)), mode=mode)
    v = _rhs((2, 3, N), 16).astype(np.float32)
    out = tprec(t(v))
    assert out.shape == (2, 3, N)
    scaled_close(out, jprec(jnp.asarray(v)), 2e-4)
    scaled_close(tprec(t(v[1, 2])), out[1, 2], 1e-5)
    assert tprec(t(v).double()).dtype == torch.float64   # cast back up


def test_preconditioner_from_solver_shares_the_plans():
    gen = torch.Generator().manual_seed(0)
    a = t(_spd_with_cond(32, 10.0, 17), torch.float32)
    cfg = torch_cfg(JCfg(array_size=8, nonideal=JNi(sigma=0.05)))
    solver = tb.ProgrammedSolver.program(a, gen, cfg, 2, device="cpu")
    prec = th.AnalogPreconditioner.from_solver(solver)
    assert prec.aplan is solver.arena and prec.fin is solver.finalized
    b = t(_rhs((32, 3), 18), torch.float32)
    assert torch.equal(prec(b.T).T, solver.solve(b))


# ------------------------------- refine -----------------------------------

def test_sanitize_seed_matches_jax_on_a_nan_column():
    x0 = _rhs((3, 8), 19).astype(np.float32)
    x0[1, 4] = np.nan
    x0[2, 0] = np.inf
    got = trefine._sanitize_seed(t(x0))
    want = np.asarray(jax.jit(jh.refine._sanitize_seed)(jnp.asarray(x0)))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got[0], t(x0[0])) and torch.all(got[1:] == 0.0)
    # a poisoned seed column starts cold and still converges
    a = t(_spd_with_cond(8, 10.0, 20))

    def poisoned(v):
        out = torch.linalg.solve(a, v.T).T
        out[0] = float("nan")
        return out
    res = trefine._refine_core(a, t(_rhs((2, 8), 21)), poisoned, "cg",
                               1e-10, 100, 8, False)
    assert bool(res.converged.all()) and bool(torch.isfinite(res.x).all())


@pytest.mark.parametrize("method", ["cg", "gmres"])
def test_solve_refined_and_gradient_match_jax(method):
    """The refined solve, and the gradient of a loss through it (the IFT
    adjoint: one seed-less solve against A^T), equal jax.grad's."""
    jcfg = CG_CFG if method == "cg" else GMRES_CFG
    a = _spd_with_cond(N, 1e3, 22)
    b = _rhs((N, 2), 23)
    w = _rhs((N, 2), 24)
    kw = dict(method=method, tol=1e-10, maxiter=2000, restart=16)
    with jax.enable_x64(True):
        jprec, tprec = _preconds(a, jcfg)

        def loss(aa, bb):
            x, _ = jh.solve_refined(aa, bb, jprec, **kw)
            return jnp.sum(x * jnp.asarray(w))
        jx, jres = jh.solve_refined(jnp.asarray(a), jnp.asarray(b), jprec,
                                    **kw)
        ga, gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a),
                                                jnp.asarray(b))
    ta, tbv = t(a).requires_grad_(), t(b).requires_grad_()
    x, res = th.solve_refined(ta, tbv, tprec, **kw)
    assert x.shape == (N, 2) and bool(res.converged.all())
    _iters_close(res.iters, jres.iters, slack=1 if method == "cg" else 0)
    scaled_close(x.detach(), jx, 1e-8)
    (x * t(w)).sum().backward()
    scaled_close(ta.grad, ga, 1e-6)
    scaled_close(tbv.grad, gb, 1e-6)


def test_solve_fallback_matches_jax():
    a = _spd_with_cond(32, 1e2, 25)
    b = _rhs(32, 26)
    with jax.enable_x64(True):
        jx, jres = jh.solve_fallback(jnp.asarray(a), jnp.asarray(b),
                                     tol=1e-10)
    x, res = th.solve_fallback(t(a), t(b), tol=1e-10, device="cpu")
    assert x.shape == (32,)
    _iters_close(res.iters, jres.iters)
    scaled_close(x, jx, 1e-8)


def test_solve_refined_batched_is_one_solve_per_generator():
    a = t(_spd_with_cond(32, 10.0, 27), torch.float32)
    b = t(_rhs((32, 2), 28), torch.float32)
    cfg = torch_cfg(JCfg(array_size=8, nonideal=JNi(sigma=0.05)))
    res = th.solve_refined_batched(
        a, b, [torch.Generator().manual_seed(s) for s in (1, 2)], cfg,
        stages=2, tol=1e-5, maxiter=200, use_precond=False, device="cpu")
    assert res.x.shape == (2, 2, 32) and res.iters.shape == (2, 2)
    prec = th.AnalogPreconditioner.program(
        a, torch.Generator().manual_seed(2), cfg, 2, device="cpu")
    x, one = th.solve_refined(a, b, prec, tol=1e-5, maxiter=200,
                              use_precond=False)
    assert torch.equal(res.x[1], x.T)
    assert torch.equal(res.iters[1], one.iters)
    assert bool(res.converged.all())


def test_hybrid_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the request would succeed")
    cfg = torch_cfg(JCfg(array_size=8))
    with pytest.raises(RuntimeError, match="cuda"):
        th.AnalogPreconditioner.program(torch.eye(16), torch.Generator(),
                                        cfg, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        th.solve_fallback(torch.eye(16), torch.ones(16))
    with pytest.raises(RuntimeError, match="cuda"):
        th.solve_refined_batched(torch.eye(16), torch.ones(16),
                                 [torch.Generator()], cfg)


# ------------------------------- classic ----------------------------------

def test_classic_refinement_matches_jax():
    a = _spd_with_cond(24, 50.0, 29)
    b = _rhs(24, 30)
    x0 = 0.9 * np.linalg.solve(a, b)
    ta, tbv, tx0 = t(a), t(b), t(x0)
    with jax.enable_x64(True):
        ja, jbv, jx0 = map(jnp.asarray, (a, b, x0))
        scaled_close(th.richardson_refine(ta, tbv, tx0, 20),
                     jh.richardson_refine(ja, jbv, jx0, 20), 1e-10)
        scaled_close(th.richardson_refine(ta, tbv, tx0, 5, omega=0.1),
                     jh.richardson_refine(ja, jbv, jx0, 5, omega=0.1), 1e-10)
        scaled_close(th.cg_refine(ta, tbv, tx0, 10),
                     jh.cg_refine(ja, jbv, jx0, 10), 1e-8)
        for method in ("cg", "richardson"):
            jx, jk = jh.iterations_to_tol(ja, jbv, jx0, tol=1e-6,
                                          method=method, max_iters=400)
            x, k = th.iterations_to_tol(ta, tbv, tx0, tol=1e-6,
                                        method=method, max_iters=400)
            assert abs(k - int(jk)) <= 1
            scaled_close(x, jx, 1e-5)
        _, k_fuel = th.iterations_to_tol(ta, tbv, t(np.zeros(24)), tol=1e-30,
                                         max_iters=7)
        assert k_fuel == 7


# ------------------------------- service ----------------------------------

SVC_CFG = JCfg(array_size=4, nonideal=JNi(sigma=0.05), opa_gain=1e4)


def test_service_refined_paths_and_stats_match_jax_service():
    """solve_refined, flush(refined=True) (padded to a power of two) and
    solve_fallback on a carried plan: the port answers and counts as the
    JAX service does."""
    n = 16
    rng = np.random.default_rng(31)
    x = rng.normal(size=(4 * n, n))
    a = (x.T @ x / (4 * n)).astype(np.float32)
    js = jb.ProgrammedSolver.program(jnp.asarray(a), jax.random.PRNGKey(0),
                                     SVC_CFG, 2)
    ts = interop.solver_from_numpy(flat_plan_dict(js.flat),
                                   torch_cfg(SVC_CFG), device="cpu")
    jsvc, tsvc = JService(SVC_CFG, stages=2), SolverService(
        torch_cfg(SVC_CFG), stages=2, device="cpu")
    jsvc.install("m", js, jnp.asarray(a))
    tsvc.install("m", ts, a)
    b = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    scaled_close(tsvc.solve_refined("m", t(b)),
                 jsvc.solve_refined("m", jnp.asarray(b)), 1e-4)
    cols = rng.uniform(-1, 1, size=(3, n)).astype(np.float32)
    for col in cols:
        tsvc.submit("m", t(col))
        jsvc.submit("m", jnp.asarray(col))
    got = tsvc.flush("m", refined=True, tol=1e-6)
    assert got.shape == (n, 3) and tsvc.pending("m") == 0
    scaled_close(got, jsvc.flush("m", refined=True, tol=1e-6), 1e-4)
    x64 = np.linalg.solve(a.astype(np.float64), cols.T.astype(np.float64))
    scaled_close(got.double(), x64, 1e-4)
    scaled_close(tsvc.solve_fallback("m", t(b[:, 0])),
                 jsvc.solve_fallback("m", jnp.asarray(b[:, 0])), 1e-4)
    ts_, js_ = tsvc.stats("m"), jsvc.stats("m")
    assert (ts_.solve_calls, ts_.rhs_served, ts_.refined_calls) == \
        (js_.solve_calls, js_.rhs_served, js_.refined_calls) == (3, 6, 3)
    assert abs(ts_.refine_iters - js_.refine_iters) <= 6   # one per rhs
    assert tsvc.flush("m", refined=True).shape == (n, 0)
