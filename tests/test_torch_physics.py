"""The port's physics layer (`repro_torch.physics`: the exact nodal wire
model, write-verify, stuck-at faults) and the paths that run it, against
the JAX package, on numpy inputs made from a seed.

The JAX side runs under `jax.enable_x64` where the comparison is in
float64.  Tolerances:
  * nodal functions, write-verify and the block-Thomas sweeps in float64:
    1e-10 of max|.| - the same recursions, summed in another order;
  * the port's float32 nodal readout against its own float64 answer:
    1e-3 of max|H - g|, the IR-drop effect itself (the residual
    formulation keeps float32 usable; measured ~1e-5 here);
  * fault-aware remapping and the stuck stamp on masks made by JAX:
    exact;
  * the port's own fault draws: the stuck fraction within 5 binomial
    standard deviations;
  * solvers under the nodal model against JAX in float32: 1e-5 of max|x|
    for the flat reference path (the same op order, other matmul and
    LAPACK kernels), rtol 2e-4 of max|x| for arena-form paths (explicit
    inverses from another LAPACK path; TESTING.md's executor contract).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockamc as jb
from repro.core.analog import AnalogConfig as JCfg
from repro.core.nonideal import NonidealConfig as JNi
from repro.kernels import ops as jops
from repro.physics import dynamics as jdyn
from repro.physics import faults as jfaults
from repro.physics import nodal as jnodal
from repro_torch import interop
from repro_torch.core import blockamc as tb
from repro_torch.kernels import banded_solve as tbanded
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.physics import dynamics as tdyn
from repro_torch.physics import faults as tfaults
from repro_torch.physics import nodal as tnodal
from _torch_parity import flat_plan_dict, scaled_close, t, torch_cfg

G0 = 100e-6
R_SEG = 1.0
F64_REL = 1e-10


def _g(shape, seed=0, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=shape) * G0


@functools.cache
def _jitted(fn, kw):
    return jax.jit(functools.partial(fn, **dict(kw)))


def _jax(fn, *args, **kw):
    """Run a JAX function, jitted with its keyword arguments bound as
    constants (the reference's static arguments); return numpy."""
    out = _jitted(fn, tuple(sorted(kw.items())))(
        *[a if isinstance(a, jax.Array) else jnp.asarray(a) for a in args])
    return np.asarray(out)


def _x64(fn, *args, **kw):
    """`_jax` in float64."""
    with jax.enable_x64(True):
        return _jax(fn, *args, **kw)


def _close64(actual, expected):
    scaled_close(actual, expected, F64_REL)


SHAPES = [(2, 2), (5, 5), (8, 8), (5, 3), (3, 8)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_nodal_single_crossbar_matches_jax(shape):
    nr, nc = shape
    g = _g(shape, seed=nr * 10 + nc)
    v = np.random.default_rng(1).uniform(-1, 1, size=(nc, 3))
    tg = t(g)
    h = tnodal.nodal_effective_conductance(tg, R_SEG)
    assert h.dtype == torch.float64
    _close64(h, _x64(jnodal.nodal_effective_conductance, g, r_seg=R_SEG))
    # H is the operator the circuit computes with: its drives agree
    currents = tnodal.nodal_mvm_currents(tg, t(v), R_SEG)
    _close64(currents, h @ t(v))
    _close64(tnodal.nodal_mvm_currents(tg, t(v[:, 0]), R_SEG), currents[:, 0])
    if nr != nc:
        _close64(currents, _x64(jnodal.nodal_mvm_currents, g, v,
                                r_seg=R_SEG))
    else:
        _close64(tnodal.row_schur_blocks(tg, R_SEG),
                 _x64(jnodal.row_schur_blocks, g, r_seg=R_SEG))
        wd = tnodal._wl_diag(tg, 1.0 / R_SEG)
        rows = np.broadcast_to(v, (nr,) + v.shape).copy()
        _close64(tnodal._thomas_solve(wd, 1.0 / R_SEG, t(rows)),
                 _x64(lambda d, r: jnodal._thomas_solve(d, 1.0 / R_SEG, r),
                      wd.numpy(), rows))
        g_inv = g + 3.0 * G0 * np.eye(nr)
        _close64(tnodal.nodal_inv_outputs(t(g_inv), t(v[:, 0]), R_SEG, G0),
                 _x64(jnodal.nodal_inv_outputs, g_inv, v[:, 0],
                      r_seg=R_SEG, g0=G0))


def test_nodal_batched_matches_jax_with_and_without_chunk():
    g = _g((5, 4, 6), seed=3)
    rng = np.random.default_rng(4)
    drives = {"shared vector": rng.uniform(-1, 1, size=6),
              "per-instance vectors": rng.uniform(-1, 1, size=(5, 6)),
              "shared multi-drive": rng.uniform(-1, 1, size=(6, 2)),
              "per-instance multi-drive": rng.uniform(-1, 1, size=(5, 6, 2))}
    for what, v in drives.items():
        want = _x64(jnodal.nodal_mvm_batched, g, v, r_seg=R_SEG)
        for chunk in (None, 2, 5, 9):
            out = tnodal.nodal_mvm_batched(t(g), t(v), R_SEG, chunk=chunk)
            assert out.shape == want.shape, what
            _close64(out, want)
    _close64(tnodal.nodal_effective_conductance_batched(t(g), R_SEG,
                                                        chunk=2),
             _x64(jnodal.nodal_effective_conductance_batched, g,
                  r_seg=R_SEG))
    ginv = _g((3, 4, 4), seed=5) + 3.0 * G0 * np.eye(4)
    v = rng.uniform(-1, 1, size=(3, 4))
    _close64(tnodal.nodal_inv_batched(t(ginv), t(v), R_SEG, G0, chunk=2),
             _x64(jnodal.nodal_inv_batched, ginv, v, r_seg=R_SEG, g0=G0))


def test_nodal_drive_rule_when_batch_equals_columns():
    """B == nc: a (B, nc) drive is a shared multi-drive, as in the
    reference; (B, nc, 1) forces per-instance vectors."""
    g = _g((4, 3, 4), seed=6)
    v = np.random.default_rng(7).uniform(-1, 1, size=(4, 4))
    out = tnodal.nodal_mvm_batched(t(g), t(v), R_SEG)
    assert out.shape == (4, 3, 4)
    _close64(out, _x64(jnodal.nodal_mvm_batched, g, v, r_seg=R_SEG))
    per = tnodal.nodal_mvm_batched(t(g), t(v[:, :, None]), R_SEG)
    assert per.shape == (4, 3, 1)
    _close64(per, _x64(jnodal.nodal_mvm_batched, g, v[:, :, None],
                       r_seg=R_SEG))


def test_nodal_ideal_wires_short_circuit():
    g = _g((3, 4), seed=8)
    v = np.random.default_rng(9).uniform(-1, 1, size=4)
    tg = t(g)
    assert tnodal.nodal_effective_conductance(tg, 0.0) is tg
    stack = tg[None]
    assert tnodal.nodal_effective_conductance_batched(stack, 0.0) is stack
    assert torch.equal(tnodal.nodal_mvm_currents(tg, t(v), 0.0), tg @ t(v))
    _close64(tnodal.nodal_mvm_batched(tg[None], t(v), 0.0)[0], g @ v)
    sq = _g((4, 4), seed=10) + 3.0 * G0 * np.eye(4)
    _close64(tnodal.nodal_inv_outputs(t(sq), t(v), 0.0, G0),
             -G0 * np.linalg.solve(sq, v))
    assert tdyn.write_verify(tg, 0.0) is tg
    # no solve, no kernel: the short circuit comes first even when a
    # kernel is asked for on the host
    assert tnodal.nodal_effective_conductance(tg, 0.0, use_kernel=True) \
        is tg


def test_nodal_float32_tracks_float64():
    g = _g((3, 32, 32), seed=11)
    h64 = tnodal.nodal_effective_conductance_batched(t(g), R_SEG)
    h32 = tnodal.nodal_effective_conductance_batched(t(g).float(), R_SEG)
    effect = float((h64 - t(g)).abs().max())
    err = float((h32.double() - h64).abs().max())
    assert effect > 0 and err <= 1e-3 * effect, (err, effect)


def test_use_kernel_true_on_the_host_raises():
    g = t(_g((2, 3, 3), seed=12))
    before = tbanded.block_tridiag_solve.launches
    with pytest.raises(ValueError, match="CUDA"):
        tnodal.nodal_effective_conductance_batched(g, R_SEG,
                                                   use_kernel=True)
    plain = tnodal.nodal_effective_conductance_batched(g, R_SEG,
                                                       use_kernel=False)
    assert torch.equal(plain,
                       tnodal.nodal_effective_conductance_batched(g, R_SEG))
    assert tbanded.block_tridiag_solve.launches == before


def test_use_kernel_reaches_nodal_write_verify():
    """Programming takes `use_kernel` down to write-verify's readouts, so a
    plain run compares every nodal readout of a programmed plan."""
    ni = JNi(sigma=0.05, r_wire=R_SEG, wire_model="nodal",
             compensate_wire=True)
    tcfg = torch_cfg(JCfg(array_size=4, nonideal=ni))
    a, _ = _problem(8, seed=4)
    parts = tb.partition_system(t(a), tcfg, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tdyn.write_verify(t(_g((2, 3, 3), seed=5)), R_SEG, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tb.program_system(parts, torch.Generator(), tcfg, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tb.build_original_plan(t(a), torch.Generator(), tcfg,
                               use_kernel=True)
    plain = tb.compile_plan(tb.program_system(
        parts, torch.Generator().manual_seed(6), tcfg, use_kernel=False))
    default = tb.compile_plan(tb.program_system(
        parts, torch.Generator().manual_seed(6), tcfg))
    for p, d in zip(plain.inv_stacks + plain.mvm_stacks,
                    default.inv_stacks + default.mvm_stacks):
        assert torch.equal(p.gpos, d.gpos) and torch.equal(p.gneg, d.gneg)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_block_tridiag_wrapper_takes_float32_or_float64(dtype):
    minv = torch.zeros((1, 2, 3, 3), dtype=dtype)
    with pytest.raises(ValueError, match="float32 or float64"):
        tops.block_tridiag_solve(minv, torch.zeros((1, 2, 3, 4),
                                                   dtype=dtype), gw=1.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_tridiag_plain_version_matches_jax_pallas_interpret(dtype):
    rng = np.random.default_rng(13)
    minv = (rng.normal(size=(3, 4, 5, 5)) * 0.3).astype(dtype)
    rhs = rng.normal(size=(3, 4, 5, 7)).astype(dtype)
    gw = 0.7
    out = tops.block_tridiag_solve(t(minv), t(rhs), gw=gw)
    assert out.dtype == torch.from_numpy(rhs).dtype
    with jax.enable_x64(True):
        want = np.asarray(jops.block_tridiag_solve(
            jnp.asarray(minv), jnp.asarray(rhs), gw=gw, interpret=True))
    scaled_close(out, want, F64_REL if dtype == np.float64 else 1e-5)
    assert torch.equal(out, tref.block_tridiag_solve_ref(t(minv), t(rhs),
                                                         gw=gw))


@pytest.mark.parametrize("model", ["first_order", "nodal"])
def test_write_verify_matches_jax(model):
    g = _g((2, 5, 4), seed=14, hi=0.8)
    out = tdyn.write_verify(t(g), R_SEG, model=model, iters=3)
    want = np.stack([_x64(jdyn.write_verify, gi, r_seg=R_SEG, model=model,
                          iters=3) for gi in g])     # one compile, reused
    _close64(out, want)
    capped = tdyn.write_verify(t(g[0]), R_SEG, model=model, iters=2,
                               damping=0.5, g_max=0.5 * G0)
    _close64(capped, _x64(jdyn.write_verify, g[0], r_seg=R_SEG, model=model,
                          iters=2, damping=0.5, g_max=0.5 * G0))
    with pytest.raises(ValueError):
        tdyn.write_verify(t(g), R_SEG, model="spice")


def test_drift_matches_jax():
    g = _g((3, 4, 4), seed=15)
    _close64(tdyn.drift_conductance(t(g), 100.0, 0.05),
             _x64(jdyn.drift_conductance, g, t=100.0, nu=0.05))
    ages = np.array([0.5, 10.0, 1e4])
    _close64(tdyn.drift_traced(t(g), t(ages), 0.05),
             _x64(jdyn.drift_traced, g, ages, nu=0.05))
    assert tdyn.drift_conductance(t(g), 0.0, 0.05) is not None


def _jax_masks(key, shape, p_on, p_off):
    on, off = jfaults.sample_stuck_masks(key, shape, p_on, p_off)
    return np.asarray(on), np.asarray(off)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fault_remap_matches_jax_on_jax_masks(seed):
    shape, p_on, p_off = (12, 10), 0.08, 0.12
    rng = np.random.default_rng(seed)
    tgt = np.maximum(rng.normal(size=shape), 0.0).astype(np.float32) * G0
    g = (tgt + rng.normal(size=shape).astype(np.float32) * 0.05 * G0)
    g = np.maximum(g, 0.0).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    on, off = _jax_masks(key, shape, p_on, p_off)
    p, q = tfaults.fault_aware_permutations(t(tgt), t(on), t(off), G0, 0.0)
    jp, jq = jax.jit(jfaults.fault_aware_permutations, static_argnums=(3, 4))(
        jnp.asarray(tgt), jnp.asarray(on), jnp.asarray(off), G0, 0.0)
    assert np.array_equal(p.numpy(), np.asarray(jp))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    for remap in (False, True):
        out = tfaults.apply_stuck_masks(t(g), t(tgt), t(on), t(off), g_on=G0,
                                        g_off=0.0, remap=remap)
        want = _jax(jfaults.apply_stuck_faults, g, tgt, key, p_on=p_on,
                    p_off=p_off, g_on=G0, g_off=0.0, remap=remap)
        assert np.array_equal(out.numpy(), want)


def test_fault_stamp_on_a_stack_matches_jax_per_array():
    """The reference draws each array of a stack from its own split key;
    fed those masks, the port's stack stamp equals it array for array."""
    shape, p_on, p_off = (3, 8, 8), 0.1, 0.1
    rng = np.random.default_rng(16)
    tgt = (np.maximum(rng.normal(size=shape), 0.0) * G0).astype(np.float32)
    key = jax.random.PRNGKey(5)
    masks = [_jax_masks(k, shape[1:], p_on, p_off)
             for k in jax.random.split(key, shape[0])]
    on = np.stack([m[0] for m in masks])
    off = np.stack([m[1] for m in masks])
    out = tfaults.apply_stuck_masks(t(tgt), t(tgt), t(on), t(off), g_on=G0,
                                    g_off=0.0, remap=True)
    want = _jax(jfaults.apply_stuck_faults, tgt, tgt, key, p_on=p_on,
                p_off=p_off, g_on=G0, g_off=0.0, remap=True)
    assert np.array_equal(out.numpy(), want)


def test_fault_draws_statistics():
    p_on, p_off, shape = 0.02, 0.03, (16, 64, 64)
    n = int(np.prod(shape))
    gen = torch.Generator().manual_seed(17)
    on, off = tfaults.sample_stuck_masks(gen, shape, p_on, p_off)
    assert not bool((on & off).any())
    for mask, p in ((on, p_on), (off, p_off)):
        frac = float(mask.double().mean())
        assert abs(frac - p) <= 5 * np.sqrt(p * (1 - p) / n), (frac, p)
    g = torch.full(shape, 0.5 * G0, dtype=torch.float64)
    out = tfaults.apply_stuck_faults(g, g, torch.Generator().manual_seed(17),
                                     p_on=p_on, p_off=p_off, g_on=G0,
                                     g_off=0.0)
    assert torch.equal(out == G0, on) and torch.equal(out == 0.0, off)


def test_stuck_faults_in_programming_follow_the_generator():
    ni = JNi(p_stuck_on=0.05, p_stuck_off=0.05, remap_faults=True)
    cfg = torch_cfg(JCfg(array_size=8, nonideal=ni))
    tgt = torch.from_numpy(_g((6, 8, 8), seed=18))
    from repro_torch.core import nonideal as tni
    a = tni.program_conductances(tgt, torch.Generator().manual_seed(3),
                                 cfg.nonideal, G0)
    b = tni.program_conductances(tgt, torch.Generator().manual_seed(3),
                                 cfg.nonideal, G0)
    assert torch.equal(a, b)
    stuck = (a == G0) | (a == 0.0)
    frac = float(stuck.double().mean())
    assert 0.03 < frac < 0.2          # ~10% faults; zero targets may hide
    assert torch.equal(a[~stuck], tgt[~stuck])


NODAL_CFG = JCfg(array_size=4, nonideal=JNi(sigma=0.05, r_wire=R_SEG,
                                            wire_model="nodal"))


def _problem(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4 * n, n))
    a = (x.T @ x / (4 * n)).astype(np.float32)
    b = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    return a, b


def test_arena_under_nodal_model_on_jax_programmed_plan():
    a, b = _problem(8)
    fp = jax.jit(jb.build_flat_plan, static_argnums=(2, 3))(
        jnp.asarray(a), jax.random.PRNGKey(0), NODAL_CFG, 1)
    fin = jax.jit(jb.finalize, static_argnums=1)(fp, NODAL_CFG)
    want = jb.execute_arena(jb.compile_arena(fin), jnp.asarray(b),
                            use_kernel=False)
    tfp = interop.flat_plan_from_numpy(flat_plan_dict(fp), device="cpu")
    tcfg = torch_cfg(NODAL_CFG)
    ap = tb.compile_arena(tb.finalize(tfp, tcfg))
    out = tb.execute_arena(ap, t(b))
    scaled_close(out, want, 2e-4)
    scaled_close(tb.execute_flat(tfp, t(b), tcfg),
                 jax.jit(jb.execute_flat, static_argnums=2)(
                     fp, jnp.asarray(b), NODAL_CFG), 1e-5)


IDEAL_NODAL = JNi(r_wire=R_SEG, wire_model="nodal")


@pytest.mark.parametrize("mode", ["reference", "fused"])
def test_solve_batched_under_nodal_model_matches_jax(mode):
    a, b = _problem(16, seed=1)
    jcfg = JCfg(array_size=8, nonideal=IDEAL_NODAL)
    want = jb.solve_batched(jnp.asarray(a), jnp.asarray(b[:, 0]),
                            jax.random.split(jax.random.PRNGKey(0), 3), jcfg,
                            stages=1, mode=mode)
    gens = [torch.Generator().manual_seed(i) for i in range(3)]
    out = tb.solve_batched(t(a), t(b[:, 0]), gens, torch_cfg(jcfg), stages=1,
                           mode=mode)
    assert out.shape == (3, 16)
    scaled_close(out, want, 1e-5 if mode == "reference" else 2e-4)


def test_solve_original_under_nodal_model_matches_jax():
    a, b = _problem(16, seed=2)
    jcfg = JCfg(array_size=4, nonideal=IDEAL_NODAL)
    tcfg = torch_cfg(jcfg)
    key = jax.random.PRNGKey(0)
    one = tb.solve_original(t(a), t(b[:, 0]), torch.Generator(), tcfg)
    scaled_close(one, _jax(jb.solve_original, a, b[:, 0], key, cfg=jcfg),
                 1e-5)
    want = jb.solve_original_batched(jnp.asarray(a), jnp.asarray(b),
                                     jax.random.split(key, 2), jcfg)
    out = tb.solve_original_batched(t(a), t(b), [torch.Generator()] * 2, tcfg)
    assert out.shape == (2, 16, 3)
    scaled_close(out, want, 1e-5)


def test_monte_carlo_batch_equals_its_simulations_one_by_one():
    """One generator per simulation, drawn in the single-plan order: the
    batched drivers give each simulation the plan `build_plan` would."""
    a, b = _problem(16, seed=3)
    ni = JNi(sigma=0.05, r_wire=R_SEG, wire_model="nodal",
             compensate_wire=True, p_stuck_on=0.01, p_stuck_off=0.01,
             remap_faults=True)
    tcfg = torch_cfg(JCfg(array_size=8, nonideal=ni))
    gens = [torch.Generator().manual_seed(20 + i) for i in range(3)]
    xs = tb.solve_batched(t(a), t(b), gens, tcfg, stages=1)
    for i in range(3):
        fp = tb.compile_plan(tb.build_plan(
            t(a), torch.Generator().manual_seed(20 + i), tcfg, 1))
        scaled_close(xs[i], tb.execute_flat(fp, t(b), tcfg), 1e-5)
    orig = tb.solve_original_batched(
        t(a), t(b), [torch.Generator().manual_seed(30)], tcfg)
    scaled_close(orig[0], tb.solve_original(
        t(a), t(b), torch.Generator().manual_seed(30), tcfg), 1e-5)
