"""The port's tile solver (`core/distributed.py`) against the JAX package.

`block_inv` and `mvm_tiled_vec` get the same numpy inputs in both
packages.  Programming noise cannot be replayed, so `dist_execute` runs
noisy plans that JAX built, carried across with
`repro_torch.interop.dist_plan_from_numpy`; the port's own programming is
compared at sigma=0, where no noise is drawn.

Tolerances: 1e-5 of max|out| where both packages run the same f32 math in
another summation order (products, einsums); 2e-4 of max|x| for whole
cascades, whose leaf solves go through another LAPACK path and whose
noisy operators amplify that rounding (the arena paths' tolerance,
TESTING.md); against a float64 solve, the paper metric below 1e-4 for
the ideal configuration (f32 arithmetic, cond ~9 Wishart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core.analog import AnalogConfig as JCfg
from repro.core.nonideal import NonidealConfig as JNi
from repro_torch import interop
from repro_torch.core import distributed as tdist
from repro_torch.core.analog import TileGrid
from _torch_parity import dist_plan_dict, scaled_close, t, torch_cfg


def _wishart(n, seed):
    x = np.random.default_rng(seed).normal(size=(4 * n, n))
    return (x.T @ x / (4 * n)).astype(np.float32)


def _rhs(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)


@pytest.mark.parametrize("n,leaf", [(64, 8), (64, 64), (48, 16)])
def test_block_inv_matches_jax(n, leaf):
    a = _wishart(n, n + leaf)
    out = tdist.block_inv(t(a), leaf)
    scaled_close(out, jdist.block_inv(jnp.asarray(a), leaf), 1e-5)
    scaled_close(out.double() @ t(a).double(), np.eye(n), 1e-4)


def test_mvm_tiled_vec_matches_jax():
    jcfg = JCfg(array_size=8, nonideal=JNi(r_wire=1.0))
    rng = np.random.default_rng(2)
    gp, gn = (rng.uniform(0, 100e-6, size=(2, 3, 8, 8)).astype(np.float32)
              for _ in range(2))
    v = rng.uniform(-1, 1, 24).astype(np.float32)
    jg = jdist.TileGrid(jnp.asarray(gp), jnp.asarray(gn), 1.0, 100e-6)
    tg = TileGrid(t(gp), t(gn), torch.tensor(1.0), 100e-6)
    out = tdist.mvm_tiled_vec(tg, t(v), torch_cfg(jcfg))
    assert out.shape == (16,)
    scaled_close(out, jdist.mvm_tiled_vec(jg, jnp.asarray(v), jcfg), 1e-5)


@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("ni", [dict(sigma=0.05),
                                dict(sigma=0.05, r_wire=1.0)])
def test_dist_execute_on_carried_jax_plans(stages, ni):
    """A noisy plan JAX programmed (n=64, 8x8 arrays) answers the same in
    both packages."""
    jcfg = JCfg(array_size=8, nonideal=JNi(**ni))
    a, b = _wishart(64, stages), _rhs(64, stages)
    jplan = jdist.build_dist_plan(jnp.asarray(a), jax.random.PRNGKey(stages),
                                  jcfg, stages)
    tplan = interop.dist_plan_from_numpy(dist_plan_dict(jplan),
                                         device="cpu")
    assert [g.shape for g in tplan.mvm2] == [
        tuple(g.gpos.shape) for g in jplan.mvm2]
    assert tplan.leaves.shape == tuple(jplan.leaves.gpos.shape)
    x = tdist.dist_execute(tplan, t(b), torch_cfg(jcfg))
    assert x.shape == (64,) and bool(torch.isfinite(x).all())
    scaled_close(x, jdist.dist_execute(jplan, jnp.asarray(b), jcfg), 2e-4)


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_build_dist_plan_at_sigma0_matches_jax(stages):
    """With no noise drawn the port programs JAX's plan: every level's
    stacks and the leaves to f32 rounding of the Schur products."""
    jcfg = JCfg(array_size=8)
    a = _wishart(64, 10 + stages)
    jplan = jdist.build_dist_plan(jnp.asarray(a), jax.random.PRNGKey(0),
                                  jcfg, stages)
    tplan = tdist.build_dist_plan(t(a), torch.Generator(), torch_cfg(jcfg),
                                  stages, device="cpu")
    for tg, jg in zip(tplan.mvm2 + tplan.mvm3 + [tplan.leaves],
                      jplan.mvm2 + jplan.mvm3 + [jplan.leaves]):
        assert tg.shape == tuple(jg.gpos.shape)
        scaled_close(tg.gpos, jg.gpos, 1e-5)
        scaled_close(tg.gneg, jg.gneg, 1e-5)


def test_solve_distributed_ideal_matches_float64_solve():
    n = 64
    a, b = _wishart(n, 7), _rhs(n, 7)
    x = tdist.solve_distributed(t(a), t(b), torch.Generator(),
                                torch_cfg(JCfg(array_size=16)), stages=2,
                                device="cpu")
    x64 = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    err = np.linalg.norm(x.double().numpy() - x64) / np.linalg.norm(x64)
    assert err < 1e-4


def test_solve_distributed_noisy_is_finite_and_seeded():
    tcfg = torch_cfg(JCfg(array_size=16, nonideal=JNi(sigma=0.05)))
    a, b = t(_wishart(64, 8)), t(_rhs(64, 8))
    runs = [tdist.solve_distributed(a, b, torch.Generator().manual_seed(s),
                                    tcfg, stages=2, device="cpu")
            for s in (1, 1, 2)]
    assert all(bool(torch.isfinite(x).all()) for x in runs)
    assert torch.equal(runs[0], runs[1])          # one seed, one draw
    assert not torch.equal(runs[0], runs[2])


def test_solve_distributed_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the request would succeed")
    with pytest.raises(RuntimeError, match="cuda"):
        tdist.solve_distributed(torch.eye(16), torch.ones(16),
                                torch.Generator(),
                                torch_cfg(JCfg(array_size=8)), stages=1)
