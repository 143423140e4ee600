"""The port's dense float64 MNA oracle (`repro_torch.core.nonideal`:
`_crossbar_laplacian`, `mna_mvm_currents`, `mna_inv_outputs`) against the
reference's, and the port's nodal solver and first-order wire model held
to it, as `tests/test_physics_oracle.py` and `tests/test_nonideal.py`
hold the reference's.

The reference's oracle is numpy float64 and is called directly (no
`jax.enable_x64`); `tests/test_physics_oracle.py` is not imported (it
fails at import on this jax).  Inputs are numpy arrays made from a seed.
Tolerances:
  * L, drive and sense: bit for bit (the same stamps in the same order,
    every index of a stamp distinct);
  * currents and outputs against the reference's: 1e-12 relative, and
    1e-12 of max|x| for the elements near zero (one dense float64 solve
    by another LAPACK build: the INV system at n=16, whose conductance
    ratio gw/g is ~1e4, differs by 5.3e-13 on an output of 0.20 where
    max|u| is 24.5);
  * the port's nodal solver (plain version, float64) against the port's
    oracle: rtol 1e-6, the reference's acceptance bound
    (`test_physics_oracle.py:65`);
  * the first-order model: 0.9 < ratio < 1.1 of the exact wire effect
    (`test_nonideal.py:23-45`); compensation: a fifth of the raw error.
"""
import numpy as np
import pytest
import torch

from repro.core import nonideal as jni
from repro_torch.core import nonideal as tni
from repro_torch.physics import nodal as tnodal
from tests._hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st

G0 = 100e-6
CPU = dict(use_kernel=False)


def _positive_array(n, seed=0, nc=None, dtype=np.float64):
    """Positive conductances scaled to G0 and a drive |N(0,1)| + 0.1, as
    numpy (`test_physics_oracle._positive_array`)."""
    rng = np.random.default_rng(seed)
    g = np.abs(rng.standard_normal((n, nc or n))).astype(dtype)
    g = g / g.max() * G0
    v = (np.abs(rng.standard_normal(nc or n)) + 0.1).astype(dtype)
    return g, v


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close_f64(got, want):
    """got (a float64 tensor) to the reference's float64 array: 1e-12
    relative, 1e-12 of max|want| absolute (module docstring)."""
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def property_cases(strategies, cases):
    """Hypothesis where installed, else the fixed cases (as
    `test_physics_oracle.property_cases`)."""
    def deco(fn):
        if HAVE_HYPOTHESIS:
            return settings(max_examples=10, deadline=None)(
                given(**strategies)(fn))
        names = list(strategies)
        return pytest.mark.parametrize(
            ",".join(names),
            [tuple(c[k] for k in names) for c in cases])(fn)
    return deco


# ---------------------------------------------------------------------------
# The port's oracle against the reference's
# ---------------------------------------------------------------------------

SHAPES = [(2, 2), (4, 4), (8, 5), (5, 8), (1, 6), (6, 1), (16, 16)]


@pytest.mark.parametrize("shape", SHAPES)
def test_laplacian_equals_the_reference_bit_for_bit(shape):
    nr, nc = shape
    g, _ = _positive_array(nr, seed=nr * 31 + nc, nc=nc)
    want = jni._crossbar_laplacian(g, 0.7)
    got = tni._crossbar_laplacian(_t(g), 0.7)
    for w, x in zip(want, got):
        assert x.dtype == torch.float64 and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), w)


@pytest.mark.parametrize("shape", SHAPES)
def test_mvm_currents_match_the_reference(shape):
    """float32 conductances in, float64 currents out (the reference's
    dtype contract), single and multi-drive."""
    nr, nc = shape
    g, v = _positive_array(nr, seed=nr * 7 + nc, nc=nc, dtype=np.float32)
    want = jni.mna_mvm_currents(g, v, 1.0)
    got = tni.mna_mvm_currents(_t(g), _t(v), 1.0)
    assert got.dtype == torch.float64
    _close_f64(got, want)
    vs = np.stack([v, 2 * v + 0.5], axis=1)
    _close_f64(tni.mna_mvm_currents(g, vs, 1.0),
               jni.mna_mvm_currents(g, vs, 1.0))


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
def test_inv_outputs_match_the_reference(n):
    g, v = _positive_array(n, seed=100 + n, dtype=np.float32)
    want = jni.mna_inv_outputs(g, v, 1.0, G0)
    got = tni.mna_inv_outputs(_t(g), _t(v), 1.0, G0)
    assert got.dtype == torch.float64 and got.shape == (n,)
    _close_f64(got, want)


def test_numpy_input_runs_on_the_host_in_float64():
    g, v = _positive_array(6, seed=12, dtype=np.float32)
    i = tni.mna_mvm_currents(g, v, 1.0)
    u = tni.mna_inv_outputs(g, v, 1.0, G0)
    for x in (i, u):
        assert x.dtype == torch.float64 and x.device.type == "cpu"
    # genuine float64 information, not a float32 round trip
    assert not torch.equal(i, i.float().double())


# ---------------------------------------------------------------------------
# The port's nodal solver held to the port's oracle (rtol 1e-6)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8, 16, 32])
def test_nodal_matches_the_oracle(n):
    g, v = _positive_array(n, seed=n)
    want = tni.mna_mvm_currents(_t(g), _t(v), 1.0)
    got = tnodal.nodal_mvm_currents(_t(g), _t(v), 1.0, **CPU)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    g, v = _positive_array(n, seed=100 + n)
    want = tni.mna_inv_outputs(_t(g), _t(v), 1.0, G0)
    got = tnodal.nodal_inv_outputs(_t(g), _t(v), 1.0, G0, **CPU)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("shape", [(8, 5), (5, 8), (1, 6), (6, 1)])
def test_nodal_matches_the_oracle_rectangular(shape):
    nr, nc = shape
    g, v = _positive_array(nr, seed=nr * 31 + nc, nc=nc)
    np.testing.assert_allclose(
        tnodal.nodal_mvm_currents(_t(g), _t(v), 1.0, **CPU).numpy(),
        tni.mna_mvm_currents(_t(g), _t(v), 1.0).numpy(), rtol=1e-6)


def test_nodal_effective_conductance_columns_are_the_oracle():
    """H = sense^T L^-1 drive: each column the oracle's currents for a
    unit drive; H @ v the nodal currents (linearity)."""
    n = 12
    g, v = _positive_array(n, seed=3)
    h = tnodal.nodal_effective_conductance(_t(g), 1.0, **CPU)
    h_dense = torch.stack([tni.mna_mvm_currents(_t(g), _t(np.eye(n)[:, j]),
                                                1.0) for j in range(n)],
                          dim=1)
    np.testing.assert_allclose(h.numpy(), h_dense.numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        (h @ _t(v)).numpy(),
        tnodal.nodal_mvm_currents(_t(g), _t(v), 1.0, **CPU).numpy(),
        rtol=1e-9)


# ---------------------------------------------------------------------------
# Limits and properties
# ---------------------------------------------------------------------------

def test_ideal_limit():
    """r_seg -> 0 recovers the ideal MVM currents and INV outputs."""
    g, v = _positive_array(12, seed=4)
    i = tni.mna_mvm_currents(_t(g), _t(v), 1e-8)
    np.testing.assert_allclose(i.numpy(), g @ v, rtol=1e-5)
    u = tni.mna_inv_outputs(_t(g), _t(v), 1e-8, G0)
    np.testing.assert_allclose(u.numpy(), -np.linalg.solve(g / G0, v),
                               rtol=1e-4)


@property_cases(
    dict(seed=st.integers(0, 2 ** 16), n=st.integers(2, 10)),
    [dict(seed=0, n=2), dict(seed=11, n=5), dict(seed=77, n=8),
     dict(seed=1234, n=10)])
def test_property_nodal_ideal_limit(seed, n):
    g, v = _positive_array(n, seed=seed)
    i = tnodal.nodal_mvm_currents(_t(g), _t(v), 1e-9, **CPU)
    np.testing.assert_allclose(i.numpy(), g @ v, rtol=1e-5)


@property_cases(
    dict(seed=st.integers(0, 2 ** 16), n=st.integers(2, 6),
         r=st.floats(min_value=0.1, max_value=2.0)),
    [dict(seed=1, n=2, r=0.1), dict(seed=22, n=4, r=1.0),
     dict(seed=333, n=6, r=2.0)])
def test_property_laplacian_symmetric_positive_definite(seed, n, r):
    """The Laplacian is symmetric positive definite: the driver and sense
    segments ground it."""
    g, _ = _positive_array(n, seed=seed)
    L, _, _ = tni._crossbar_laplacian(_t(g), r)
    assert torch.equal(L, L.T)
    assert torch.linalg.eigvalsh(L).min() > 0.0


# ---------------------------------------------------------------------------
# The first-order model and compensation against the exact circuit
# ---------------------------------------------------------------------------

def _wishart_array(n, seed):
    """|Wishart| scaled to G0 and a drive |U(-1, 1)| + 0.1 (the shapes of
    `test_nonideal._positive_array`, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4 * n, n))
    a = np.abs(x.T @ x / (4 * n))
    v = np.abs(rng.uniform(-1.0, 1.0, n)) + 0.1
    return a / a.max() * G0, v


@pytest.mark.parametrize("n", [8, 16, 24])
def test_first_order_tracks_the_exact_mvm(n):
    g, v = _wishart_array(n, seed=n)
    i_exact = tni.mna_mvm_currents(_t(g), _t(v), 1.0).numpy()
    i_ideal = g @ v
    i_fo = tni.effective_conductance(_t(g), 1.0).numpy() @ v
    d_exact, d_fo = i_exact - i_ideal, i_fo - i_ideal
    ratio = np.linalg.norm(d_exact) / np.linalg.norm(d_fo)
    corr = d_exact @ d_fo / (np.linalg.norm(d_exact) * np.linalg.norm(d_fo))
    assert 0.9 < ratio < 1.1
    assert corr > 0.99


@pytest.mark.parametrize("n", [8, 16])
def test_first_order_tracks_the_exact_inv(n):
    g, v = _wishart_array(n, seed=50 + n)
    vo_exact = tni.mna_inv_outputs(_t(g), _t(v), 1.0, G0).numpy()
    vo_ideal = -np.linalg.solve(g / G0, v)
    g_fo = tni.effective_conductance(_t(g), 1.0).numpy()
    vo_fo = -np.linalg.solve(g_fo / G0, v)
    d_exact, d_fo = vo_exact - vo_ideal, vo_fo - vo_ideal
    ratio = np.linalg.norm(d_exact) / np.linalg.norm(d_fo)
    assert 0.9 < ratio < 1.1


def test_compensation_against_the_exact_mna():
    """Compensated programming cancels the wire error in the exact
    circuit."""
    g, v = _wishart_array(16, seed=1)
    i_ideal = g @ v
    i_raw = tni.mna_mvm_currents(_t(g), _t(v), 1.0).numpy()
    g_prog = tni.compensate_conductances(_t(g), 1.0)
    i_comp = tni.mna_mvm_currents(g_prog, _t(v), 1.0).numpy()
    raw_err = np.linalg.norm(i_raw - i_ideal)
    comp_err = np.linalg.norm(i_comp - i_ideal)
    assert comp_err < 0.2 * raw_err


# ---------------------------------------------------------------------------
# On the card: the block-Thomas kernel's double instance against the oracle
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16])
def test_nodal_kernel_matches_the_oracle_on_the_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no "
                    "host mode")
    from repro_torch.kernels import banded_solve
    dev = torch.device("cuda")
    g, v = _positive_array(n, seed=n)
    gd, vd = _t(g).to(dev), _t(v).to(dev)
    before = banded_solve.block_tridiag_solve.launches
    i = tnodal.nodal_mvm_currents(gd, vd, 1.0, use_kernel=True)
    u = tnodal.nodal_inv_outputs(gd, vd, 1.0, G0, use_kernel=True)
    assert banded_solve.block_tridiag_solve.launches > before
    i_ref = tni.mna_mvm_currents(gd, vd, 1.0)
    u_ref = tni.mna_inv_outputs(gd, vd, 1.0, G0)
    assert i_ref.device.type == "cuda"
    np.testing.assert_allclose(i.cpu().numpy(), i_ref.cpu().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(u.cpu().numpy(), u_ref.cpu().numpy(),
                               rtol=1e-6)
