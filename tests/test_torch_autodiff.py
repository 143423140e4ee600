"""The port's differentiable cascade (`core/blockamc.py` `_Cascade`, the
reference's `_cascade` custom VJP) and the wire calibration built on it
(`repro_torch.calib`), against the JAX package.

Plans are programmed by JAX in float64 (under `jax.enable_x64`) and carried
across with `repro_torch.interop`; both sides then finalize and
arena-compile their own.  Tolerances (TESTING.md, executor contract):
gradients of arena-form paths rtol 2e-4 scaled to the gradient's
magnitude; the kernel path's layout on the host (the kernel's plain
version in the forward, the backward's registers recomputed on the plain
levels) against the plain path's gradient 1e-10 of max|g| in float64; a
calibration's fitted resistance within 1e-3 relative of the reference's
after the same 60 Adam steps; a planted 1 ohm recovered to 5% (the
reference's acceptance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.calib import wire as jwire
from repro.core import blockamc as jb
from repro.core.analog import AnalogConfig as JCfg
from repro.core.nonideal import NonidealConfig as JNi
from repro_torch import interop
from repro_torch.calib import calibrate_wire, calibrate_wire_to
from repro_torch.core import blockamc as tb
from repro_torch.kernels import ops
from _torch_parity import (flat_plan_dict, scaled_close, t, tile_program,
                           torch_cfg)

REGIMES = {
    "ideal": dict(nonideal=JNi(sigma=0.05), opa_gain=1e4),
    "converters": dict(nonideal=JNi(sigma=0.05), dac_bits=8, adc_bits=8),
}
# (n, array size, stages): a uniform whole-window plan (the kernel's one
# launch) and a ragged one (multi-segment windows, plain path only)
PLANS = {"uniform": (16, 8, 1), "ragged": (17, 8, 2)}


def _spd(n, seed):
    x = np.random.default_rng(seed).normal(size=(4 * n, n))
    return x.T @ x / (4 * n)


def _jax_fplan(a, jcfg, stages, seed):
    return jax.jit(jb.build_flat_plan, static_argnums=(2, 3))(
        jnp.asarray(a), jax.random.PRNGKey(seed), jcfg, stages)


def _with_grad_stacks(plan):
    """The port's plan with fresh leaf stacks that require grad."""
    return dataclasses.replace(plan, stacks=tuple(
        s.detach().clone().requires_grad_() for s in plan.stacks))


def _with_stacks(plan, stacks):
    """A JAX arena or packed plan with its operator stacks replaced (the
    gradient is taken with respect to the stacks only: the whole-schedule
    program holds integer metadata)."""
    children, aux = plan.tree_flatten()
    return type(plan).tree_unflatten(aux, (stacks,) + tuple(children[1:]))


def _port_grads(run, plan, b, w):
    """d sum(run(plan, b) * w) / d(b, *plan.stacks)."""
    plan = _with_grad_stacks(plan)
    b = t(b).requires_grad_()
    loss = (run(plan, b) * t(w)).sum()
    return torch.autograd.grad(loss, [b, *plan.stacks])


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_execute_arena_gradients_match_jax(plan, regime):
    n, asz, stages = PLANS[plan]
    rng = np.random.default_rng(1)
    b = rng.uniform(-1, 1, size=(n, 3))
    w = rng.normal(size=(n, 3))
    with jax.enable_x64(True):
        jcfg = JCfg(array_size=asz, **REGIMES[regime])
        fp = _jax_fplan(_spd(n, 0), jcfg, stages, 0)
        ap = jb.compile_arena(jb.finalize(fp, jcfg))

        def loss(stacks, b_):
            return jnp.sum(jb.execute_arena(_with_stacks(ap, stacks), b_,
                                            use_kernel=False)
                           * jnp.asarray(w))
        g_stacks, g_b = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            ap.stacks, jnp.asarray(b))
    cfg = torch_cfg(jcfg)
    tap = tb.compile_arena(tb.finalize(
        interop.flat_plan_from_numpy(flat_plan_dict(fp), "cpu"), cfg))
    assert tap.kernel_ok == (plan == "uniform")
    grads = _port_grads(
        lambda p, bb: tb.execute_arena(p, bb, use_kernel=False), tap, b, w)
    scaled_close(grads[0], g_b, 2e-4)
    assert len(grads) - 1 == len(g_stacks)
    for got, want in zip(grads[1:], g_stacks):
        scaled_close(got, want, 2e-4)
    if tap.kernel_ok:
        # the kernel path's layout: the forward through the kernel's plain
        # version, the stack cotangents from registers recomputed on the
        # plain levels - the same gradient
        kgrads = _port_grads(
            lambda p, bb: tb.execute_arena(p, bb, use_kernel=True), tap, b,
            w)
        for got, want in zip(kgrads, grads):
            scaled_close(got, want, 1e-10)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_execute_arena_packed_gradients_match_jax(use_kernel):
    n, asz, stages = PLANS["uniform"]
    rng = np.random.default_rng(2)
    bs = rng.uniform(-1, 1, size=(3, n, 2))
    w = rng.normal(size=(3, n, 2))
    with jax.enable_x64(True):
        jcfg = JCfg(array_size=asz, **REGIMES["ideal"])
        fps = [_jax_fplan(_spd(n, s), jcfg, stages, s) for s in range(3)]
        pp = jb.pack_arena_plans([jb.compile_arena(jb.finalize(fp, jcfg))
                                  for fp in fps])

        def loss(stacks, b_):
            return jnp.sum(jb.execute_arena_packed(
                _with_stacks(pp, stacks), b_, use_kernel=False)
                * jnp.asarray(w))
        g_stacks, g_b = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            pp.stacks, jnp.asarray(bs))
    cfg = torch_cfg(jcfg)
    tpp = tb.pack_arena_plans([
        tb.compile_arena(tb.finalize(
            interop.flat_plan_from_numpy(flat_plan_dict(fp), "cpu"), cfg))
        for fp in fps])
    grads = _port_grads(
        lambda p, bb: tb.execute_arena_packed(p, bb, use_kernel=use_kernel),
        tpp, bs, w)
    scaled_close(grads[0], g_b, 2e-4)
    assert len(grads) - 1 == len(g_stacks)
    for got, want in zip(grads[1:], g_stacks):
        scaled_close(got, want, 2e-4)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_wire_gradient_matches_jax(use_kernel):
    """d sum(x) / d r_wire through finalize -> compile_arena ->
    execute_arena (the reference's tests/test_autodiff.py
    test_wire_grad_matches_fd)."""
    n = 8
    b = np.random.default_rng(3).uniform(-1, 1, size=n)
    with jax.enable_x64(True):
        jcfg = JCfg(array_size=4)
        a = _spd(n, 4) + n * np.eye(n)
        fp = _jax_fplan(a, jcfg, None, 4)

        def out_at(r):
            fin = jb.finalize(fp, jcfg, r_wire=r)
            return jnp.sum(jb.execute_arena(jb.compile_arena(fin),
                                            jnp.asarray(b)))
        want = float(jax.grad(out_at)(jnp.asarray(1.0, jnp.float64)))
    tfp = interop.flat_plan_from_numpy(flat_plan_dict(fp), "cpu")
    r = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    ap = tb.compile_arena(tb.finalize(tfp, torch_cfg(jcfg), r_wire=r))
    assert ap.program is not None
    out = tb.execute_arena(ap, t(b), use_kernel=use_kernel).sum()
    (got,) = torch.autograd.grad(out, r)
    np.testing.assert_allclose(float(got), want, rtol=2e-4)


def test_calibrate_wire_to_matches_jax():
    """The same 60 Adam steps on a carried plan, probes and observations:
    the two trajectories of r_hat agree step by step."""
    n = 8
    rng = np.random.default_rng(5)
    b = rng.normal(size=(n, 4))
    with jax.enable_x64(True):
        clean = JCfg(array_size=8)
        fp = _jax_fplan(_spd(n, 5) + n * np.eye(n), clean, None, 5)
        oracle = clean.with_(nonideal=JNi(r_wire=1.0, wire_model="nodal"))
        x_obs = jb.execute_arena(jb.compile_arena(jb.finalize(fp, oracle)),
                                 jnp.asarray(b))
        want = jwire.calibrate_wire_to(fp, clean, jnp.asarray(b), x_obs,
                                       steps=60)
    got = calibrate_wire_to(
        interop.flat_plan_from_numpy(flat_plan_dict(fp), "cpu"),
        torch_cfg(clean), t(b), t(x_obs), steps=60)
    assert got.steps == 60 and len(got.r_history) == 60
    np.testing.assert_allclose(got.r_hat, want.r_hat, rtol=1e-3)
    np.testing.assert_allclose(got.r_history, want.r_history, rtol=1e-3)
    assert got.history[-1] < got.history[0]


def test_calibrate_wire_recovers_planted_resistance():
    """The port's end-to-end loop (its own programming, probes and nodal
    oracle): a planted 1 ohm recovered to 5% at n=16, 120 steps."""
    a = torch.from_numpy(_spd(16, 9) + 16 * np.eye(16))
    cal = calibrate_wire(a, r_true=1.0, steps=120, device="cpu")
    assert cal.rel_err(1.0) < 0.05, (cal.r_hat, cal.loss)
    assert cal.history[-1] < cal.history[0]


def test_kernel_wrappers_refuse_tensors_that_require_grad():
    """The kernels run outside autograd: their wrappers refuse a tensor
    that requires grad, on the host as on the card."""
    arena, ops_, *meta = (torch.from_numpy(x) for x in tile_program())
    with pytest.raises(ValueError, match="outside autograd"):
        ops.arena_packed_apply(arena.clone().requires_grad_(), ops_, *meta)
    with pytest.raises(ValueError, match="outside autograd"):
        ops.arena_level_apply(arena[0], ops_[0].requires_grad_(), *meta)
    minv = torch.eye(4).expand(1, 3, 4, 4).contiguous()
    rhs = torch.ones(1, 3, 4, 2, requires_grad=True)
    with pytest.raises(ValueError, match="outside autograd"):
        ops.block_tridiag_solve(minv, rhs, gw=1.0)
