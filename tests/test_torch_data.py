"""The port's matrix generators (`data/matrices.py`) on torch.Generators:
the properties the JAX package's generators have, and the device rule."""
import numpy as np
import pytest
import torch

from repro_torch.data import matrices
from repro_torch.device import resolve_device


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_wishart_is_spd_and_well_conditioned():
    a = matrices.wishart(_gen(), 32, device="cpu").double()
    assert a.shape == (32, 32) and torch.allclose(a, a.T)
    eig = torch.linalg.eigvalsh(a)
    assert eig.min() > 0 and eig.max() / eig.min() < 30  # ~9 for m = 4n


def test_wishart_with_cond_hits_the_condition_number():
    a = matrices.wishart_with_cond(_gen(1), 24, 100.0, dtype=torch.float64,
                                   device="cpu")
    eig = torch.linalg.eigvalsh(a)
    assert float(eig.max() / eig.min()) == pytest.approx(100.0, rel=1e-6)


def test_toeplitz_is_constant_along_diagonals():
    a = matrices.toeplitz(_gen(2), 9, device="cpu").numpy()
    for d in range(-8, 9):
        diag = np.diagonal(a, offset=d)
        assert np.all(diag == diag[0])
    assert np.all(np.abs(np.diag(a)) >= 2.0)          # boosted diagonal


def test_random_rhs_is_uniform_in_the_dac_range():
    b = matrices.random_rhs(_gen(3), 4096, device="cpu")
    assert b.shape == (4096,) and b.abs().max() <= 1.0
    assert abs(float(b.mean())) < 0.05


def test_one_seed_one_draw():
    a1 = matrices.wishart(_gen(5), 8, device="cpu")
    a2 = matrices.wishart(_gen(5), 8, device="cpu")
    assert torch.equal(a1, a2)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the request would succeed")
    with pytest.raises(RuntimeError, match="cuda"):
        matrices.wishart(_gen(), 8)
    assert resolve_device("cpu") == torch.device("cpu")
