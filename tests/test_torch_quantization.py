"""The port's converter model and metrics against the JAX package.

Same inputs (numpy, from a seed) through `repro` and `repro_torch`.  The
quantiser is one elementwise op sequence in both, so its outputs must be
equal exactly - including at rounding ties, where both round half to even,
and at the clip edges.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.core.quantization import quantize as jquantize
from repro_torch.core import metrics as tmetrics
from repro_torch.core.quantization import quantize as tquantize


def _tie_and_edge_inputs(bits, fullscale):
    step = np.float32(2.0 * fullscale / (2 ** bits - 1))
    ties = np.float32([0.5, -0.5, 1.5, -1.5, 2.5, -2.5]) * step
    fs = np.float32(fullscale)
    edges = np.float32([fs, -fs, np.nextafter(fs, np.float32(0)),
                        np.nextafter(fs, np.float32(9)), -2 * fs, 3 * fs,
                        0.0, -0.0])
    rng = np.random.default_rng(bits)
    bulk = rng.uniform(-1.5 * fullscale, 1.5 * fullscale,
                       size=256).astype(np.float32)
    return np.concatenate([ties, edges, bulk])


@pytest.mark.parametrize("bits,fullscale", [(1, 1.0), (3, 1.0), (6, 1.0),
                                            (8, 1.0), (8, 0.75)])
def test_quantize_equals_jax_on_ties_and_clip_edges(bits, fullscale):
    v = _tie_and_edge_inputs(bits, fullscale)
    out = tquantize(torch.from_numpy(v), bits, fullscale).numpy()
    ref = np.asarray(jquantize(jnp.asarray(v), bits, fullscale))
    np.testing.assert_array_equal(out, ref)


def test_quantize_rounds_half_to_even():
    step = 2.0 / 3.0                      # bits=2, fullscale=1
    v = torch.tensor([0.5, 1.5, -0.5], dtype=torch.float64) * step
    assert tquantize(v, 2, 1.0).div(step).tolist() == [0.0, 2.0, -0.0]


def test_quantize_none_is_identity():
    v = torch.randn(7)
    assert tquantize(v, None, 1.0) is v


def test_quantize_straight_through_gradient_matches_jax():
    v = _tie_and_edge_inputs(4, 1.0)
    w = np.random.default_rng(0).normal(size=v.shape).astype(np.float32)
    vt = torch.from_numpy(v).requires_grad_()
    (tquantize(vt, 4, 1.0) * torch.from_numpy(w)).sum().backward()
    ref = jax.grad(lambda x: jnp.sum(jquantize(x, 4, 1.0) * w))(
        jnp.asarray(v))
    np.testing.assert_array_equal(vt.grad.numpy(), np.asarray(ref))
    # inside the full-scale range the gradient passes, outside it is zero
    inside = np.abs(v) <= 1.0
    np.testing.assert_array_equal(vt.grad.numpy()[~inside], 0.0)
    np.testing.assert_array_equal(vt.grad.numpy()[inside], w[inside])


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    x, xh = rng.normal(size=(2, 3, 16)).astype(np.float32)
    for name in ("relative_error", "l2_relative_error"):
        out = getattr(tmetrics, name)(torch.from_numpy(x),
                                      torch.from_numpy(xh)).numpy()
        ref = np.asarray(getattr(jmetrics, name)(x, xh))
        # same formula; the reductions may sum in another order (f32)
        np.testing.assert_allclose(out, ref, rtol=1e-6)
