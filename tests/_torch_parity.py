"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py): carry
configs and programmed plans from the JAX package into repro_torch as plain
Python values and numpy arrays, the tolerance checks, and a random tile
program for the arena kernel.  Imports no JAX, so the card-only tests can
use it on a machine without JAX.  Tests import it as `_torch_parity` (pytest
puts this directory on sys.path): a `tests` package installed elsewhere
would shadow `tests._torch_parity`."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.nonideal import NonidealConfig


def torch_cfg(jcfg) -> AnalogConfig:
    """The port's AnalogConfig with the same field values as a JAX one."""
    d = dataclasses.asdict(jcfg)
    return AnalogConfig(nonideal=NonidealConfig(**d.pop("nonideal")), **d)


def flat_plan_dict(fp) -> dict:
    """A JAX FlatPlan in `repro_torch.interop`'s dict format."""
    g0 = (fp.inv_stacks or fp.mvm_stacks)[0].g0
    return {
        "n": fp.n, "g0": g0, "scale": np.asarray(fp.scale),
        "schedule": fp.schedule, "inv_keys": fp.inv_keys,
        "mvm_keys": fp.mvm_keys,
        "inv_stacks": [(np.asarray(g.gpos), np.asarray(g.gneg))
                       for g in fp.inv_stacks],
        "mvm_stacks": [(np.asarray(g.gpos), np.asarray(g.gneg))
                       for g in fp.mvm_stacks],
    }


def t(x, dtype=None) -> torch.Tensor:
    """A CPU tensor from a JAX or numpy array (copied)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def close(actual, expected, *, rtol, atol):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=rtol, atol=atol)


def scaled_close(actual, expected, rel):
    """|actual - expected| <= rel * max|expected|, elementwise: the
    tolerance of paths that only reassociate f32 sums, scaled to the
    output's magnitude."""
    actual, expected = np.asarray(actual), np.asarray(expected)
    bound = rel * max(float(np.max(np.abs(expected))), 1e-30)
    err = float(np.max(np.abs(actual - expected)))
    assert err <= bound, f"max abs err {err:.3g} > {bound:.3g}"


def quantized_close(actual, expected, step):
    """Agreement of two quantised results whose pre-ADC sums were
    reassociated: an output within rounding of a bin edge may land one
    converter step away, and that step propagates down the cascade.  So
    at most 2% of elements may differ by more than 1e-5 of max|expected|,
    and none by more than 4 steps."""
    actual, expected = np.asarray(actual), np.asarray(expected)
    err = np.abs(actual - expected)
    off = err > 1e-5 * max(float(np.max(np.abs(expected))), 1e-30)
    assert float(err.max()) <= 4 * step, f"max abs err {err.max():.3g}"
    assert off.mean() <= 0.02, f"{off.mean():.2%} of elements differ"


def tile_program(m=2, n_tiles=5, rows=8, cols=8, n_terms=3, k=3, s=40,
                 seed=0):
    """A random but valid tile program: windows inside the arena, the
    first tile of every output window an init, a zero-sign pad term."""
    rng = np.random.default_rng(seed)
    arena = rng.uniform(-1, 1, size=(m, s, k)).astype(np.float32)
    ops = (rng.normal(size=(m, n_tiles, rows, cols))
           * 0.5 / np.sqrt(cols)).astype(np.float32)
    in_offs = rng.integers(0, s - cols + 1,
                           size=(n_tiles, n_terms)).astype(np.int32)
    in_signs = rng.choice([-1.0, 1.0],
                          size=(n_tiles, n_terms)).astype(np.float32)
    in_signs[1, -1] = 0.0
    in_offs[1, -1] = 0
    out_offs = rng.integers(0, s - rows + 1, size=n_tiles).astype(np.int32)
    out_init = np.ones(n_tiles, np.int32)
    out_init[2] = out_init[4] = 0
    return arena, ops, in_offs, in_signs, out_offs, out_init
