"""The port's device non-idealities and analog circuits against the JAX
package (`core/nonideal.py`, `core/analog.py`).

Deterministic parts get the same numpy inputs in both packages.  Noise
cannot be replayed across frameworks, so programming is compared at
sigma=0, and the port's own noise is checked statistically.

Tolerances: rtol 1e-5 / atol 1e-6 (relative to G0-scaled values) where
both packages run the same f32 op order but their matmul and LAPACK
kernels may sum in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analog as janalog
from repro.core import nonideal as jni
from repro_torch.core import analog as tanalog
from repro_torch.core import nonideal as tni
from _torch_parity import close, t, torch_cfg

G0 = 100e-6
RNG = np.random.default_rng(11)


def _g(shape, lo=0.0, hi=1.0):
    return (RNG.uniform(lo, hi, size=shape) * G0).astype(np.float32)


def _rel(a, b, rtol=1e-5):
    """f32 parity for conductance-scale values: atol tied to G0."""
    close(a, b, rtol=rtol, atol=1e-6 * G0)


@pytest.mark.parametrize("r_seg", [0.0, 1.0, 5.0])
def test_effective_conductance_matches_jax(r_seg):
    g = _g((2, 3, 8, 8))                  # leading tile axes broadcast
    out = tni.effective_conductance(t(g), r_seg)
    ref = jni._over_tiles(
        lambda x: jni.effective_conductance(x, r_seg), jnp.asarray(g))
    _rel(out, ref)


def test_compensate_conductances_matches_jax():
    g = _g((8, 16))
    _rel(tni.compensate_conductances(t(g), 2.0, iters=3),
         jni.compensate_conductances(jnp.asarray(g), 2.0, iters=3))


@pytest.mark.parametrize("drift_t", [None, 0.5, 100.0, "vector"])
def test_readout_conductance_matches_jax(drift_t):
    ni_t = tni.NonidealConfig(drift_t=50.0, drift_nu=0.05)
    ni_j = jni.NonidealConfig(drift_t=50.0, drift_nu=0.05)
    g = _g((4, 8, 8))
    d = np.float32([1.0, 10.0, 1e3, 1e5]) if drift_t == "vector" else drift_t
    _rel(tni.readout_conductance(t(g), ni_t, drift_t=d),
         jni.readout_conductance(jnp.asarray(g), ni_j, drift_t=d))


@pytest.mark.parametrize("kw", [dict(r_wire=1.0), dict(r_wire=1.0,
                                                      wire_model="none"),
                                dict()])
def test_wire_readout_matches_jax(kw):
    g = _g((3, 8, 8))
    _rel(tni.wire_readout(t(g), tni.NonidealConfig(**kw)),
         jni.wire_readout(jnp.asarray(g), jni.NonidealConfig(**kw)))
    _rel(tni.wire_readout(t(g), tni.IDEAL, r_wire=2.0),
         jni.wire_readout(jnp.asarray(g), jni.IDEAL, r_wire=2.0))


def test_program_conductances_at_sigma0_matches_jax():
    ni = dict(r_wire=1.0, compensate_wire=True, wv_iters=2)
    g = _g((2, 8, 8))
    out = tni.program_conductances(t(g), torch.Generator(),
                                   tni.NonidealConfig(**ni), G0)
    ref = jni.program_conductances(jnp.asarray(g), jax.random.PRNGKey(0),
                                   jni.NonidealConfig(**ni), G0)
    _rel(out, ref)


def test_programming_noise_statistics():
    """Noise drawn by the port: g - g_target has mean 0 and std sigma*G0.

    Targets sit far above zero, so the clip at 0 never fires; with N
    devices the sample mean is within 5 standard errors of 0 and the
    sample std within 3% of sigma*G0 (its standard error is ~1/sqrt(2N),
    0.25% at N = 8192)."""
    sigma = 0.05
    target = torch.full((8, 32, 32), 0.6 * G0)
    out = tni.program_conductances(target, torch.Generator().manual_seed(3),
                                   tni.NonidealConfig(sigma=sigma), G0)
    d = (out - target).double()
    n = d.numel()
    assert abs(d.mean().item()) < 5 * sigma * G0 / n ** 0.5
    assert abs(d.std().item() / (sigma * G0) - 1.0) < 0.03
    # one seed gives one draw; another seed another
    again = tni.program_conductances(target, torch.Generator().manual_seed(3),
                                     tni.NonidealConfig(sigma=sigma), G0)
    assert torch.equal(out, again)


@pytest.mark.parametrize("kw,stage", [
    (dict(wire_model="nodal", r_wire=1.0), "readout"),
    (dict(p_stuck_on=0.01), "program"),
    (dict(compensate_wire=True, r_wire=1.0, compensate_model="nodal"),
     "program")])
def test_physics_hooks_raise_until_ported(kw, stage):
    """The physics hooks, which raised before the physics layer was
    ported, now run: the nodal readout and nodal write-verify agree with
    the JAX package (float64, 1e-10 of max|.|); stuck-at faults stamp
    G_on / G_off over the noiseless targets."""
    ni = tni.NonidealConfig(**kw)
    g = _g((2, 4, 4)).astype(np.float64)
    if stage == "readout":
        out = tni.wire_readout(t(g), ni)
        with jax.enable_x64(True):
            want = np.asarray(jni.wire_readout(jnp.asarray(g),
                                               jni.NonidealConfig(**kw)))
    elif "p_stuck_on" in kw:
        ni = tni.NonidealConfig(p_stuck_on=0.5, p_stuck_off=0.25)
        out = tni.program_conductances(t(g), torch.Generator().manual_seed(0),
                                       ni, G0)
        stuck = (out == G0) | (out == 0.0)
        assert torch.equal(out[~stuck], t(g)[~stuck]) and stuck.any()
        return
    else:
        out = tni.program_conductances(t(g), torch.Generator(), ni, G0)
        with jax.enable_x64(True):
            want = np.asarray(jni.program_conductances(
                jnp.asarray(g), jax.random.PRNGKey(0),
                jni.NonidealConfig(**kw), G0))
    assert out.dtype == torch.float64
    close(out, want, rtol=0, atol=1e-10 * np.abs(want).max())


def _pair_inputs(rows, cols, k):
    a = RNG.normal(size=(rows, cols)).astype(np.float32)
    a = a / np.abs(a).max()
    if rows == cols:
        a = a + 2.0 * np.eye(rows, dtype=np.float32)
        a = a / np.abs(a).max()
    v = RNG.uniform(-1, 1, size=(cols, k)).astype(np.float32)
    return a, v


CIRCUIT_CFGS = [dict(), dict(opa_gain=1e3),
                dict(nonideal=dict(r_wire=1.0)),
                dict(dac_bits=6, adc_bits=6)]


def _cfgs(kw):
    kw = dict(kw)
    ni = kw.pop("nonideal", {})
    jcfg = janalog.AnalogConfig(array_size=8,
                                nonideal=jni.NonidealConfig(**ni), **kw)
    return jcfg, torch_cfg(jcfg)


@pytest.mark.parametrize("kw", CIRCUIT_CFGS)
def test_map_matrix_and_circuits_match_jax(kw):
    jcfg, tcfg = _cfgs(kw)
    a, v = _pair_inputs(8, 8, 3)
    jp = janalog.map_matrix(jnp.asarray(a), jax.random.PRNGKey(0), jcfg,
                            jnp.float32(0.5))
    tp = tanalog.map_matrix(t(a), torch.Generator(), tcfg,
                            torch.tensor(0.5))
    _rel(tp.gpos, jp.gpos)
    _rel(tp.gneg, jp.gneg)
    close(tp.a_eff(tcfg), jp.a_eff(jcfg), rtol=1e-5, atol=1e-6)
    close(tanalog.amc_mvm(tp, t(v), tcfg), janalog.amc_mvm(jp, v, jcfg),
          rtol=1e-5, atol=1e-6)
    close(tanalog.amc_inv(tp, t(v), tcfg), janalog.amc_inv(jp, v, jcfg),
          rtol=1e-5, atol=1e-5)
    close(tanalog.dac(t(v), tcfg), janalog.dac(jnp.asarray(v), jcfg),
          rtol=0, atol=0)
    close(tanalog.adc(t(v), tcfg), janalog.adc(jnp.asarray(v), jcfg),
          rtol=0, atol=0)


@pytest.mark.parametrize("kw", CIRCUIT_CFGS[:3])
def test_map_tiled_ragged_matches_jax(kw):
    jcfg, tcfg = _cfgs(kw)
    a, v = _pair_inputs(11, 13, 2)       # 8-tiles with ragged edges
    jg = janalog.map_tiled(jnp.asarray(a), jax.random.PRNGKey(0), jcfg,
                           jnp.float32(1.0))
    tg = tanalog.map_tiled(t(a), torch.Generator(), tcfg, torch.tensor(1.0))
    assert [[p.shape for p in r] for r in tg] == \
        [[tuple(p.shape) for p in r] for r in jg]
    close(tanalog.amc_mvm_tiled(tg, t(v), tcfg),
          janalog.amc_mvm_tiled(jg, jnp.asarray(v), jcfg),
          rtol=1e-5, atol=1e-6)


def test_tilegrid_a_eff_with_leading_axes_matches_jax():
    ni = dict(r_wire=1.0, drift_t=30.0, drift_nu=0.02)
    jcfg = janalog.AnalogConfig(nonideal=jni.NonidealConfig(**ni))
    tcfg = torch_cfg(jcfg)
    gp, gn = _g((2, 3, 8, 8)), _g((2, 3, 8, 8))
    jt = janalog.TileGrid(jnp.asarray(gp), jnp.asarray(gn), 1.0, G0)
    tt = tanalog.TileGrid(t(gp), t(gn), torch.tensor(1.0), G0)
    close(tt.a_eff(tcfg), jt.a_eff(jcfg), rtol=1e-5, atol=1e-6)
    close(tt.pair(1).a_eff(tcfg), jt.pair(1).a_eff(jcfg), rtol=1e-5,
          atol=1e-6)


def test_configs_carry_every_field():
    jcfg = janalog.AnalogConfig()
    assert [f.name for f in dataclasses.fields(jcfg)] == \
        [f.name for f in dataclasses.fields(tanalog.AnalogConfig)]
    assert [f.name for f in dataclasses.fields(jni.NonidealConfig)] == \
        [f.name for f in dataclasses.fields(tni.NonidealConfig)]
    assert torch_cfg(jcfg) == tanalog.IDEAL_CFG


@pytest.mark.parametrize("kw", [dict(), dict(nonideal=dict(
    r_wire=1.0, compensate_wire=True))])
def test_map_tiled_vec_at_sigma0_matches_jax_exactly(kw):
    """The stacked-tile mapping programs the same conductances bit for bit
    at sigma=0 (no draws); with first-order write-verify, to f32
    rounding."""
    jcfg, tcfg = _cfgs(kw)
    a = RNG.normal(size=(16, 24)).astype(np.float32)
    scale = np.float32(1.0 / np.abs(a).max())
    jg = janalog.map_tiled_vec(jnp.asarray(a), jax.random.PRNGKey(0), jcfg,
                               jnp.asarray(scale))
    tg = tanalog.map_tiled_vec(t(a), torch.Generator(), tcfg,
                               torch.tensor(scale))
    assert tg.shape == tuple(jg.shape) == (2, 3, 8, 8)
    if not kw:
        assert np.array_equal(tg.gpos.numpy(), np.asarray(jg.gpos))
        assert np.array_equal(tg.gneg.numpy(), np.asarray(jg.gneg))
    else:
        _rel(tg.gpos, jg.gpos)
        _rel(tg.gneg, jg.gneg)
    close(tg.a_eff(tcfg), jg.a_eff(jcfg), rtol=1e-5, atol=1e-6)
    # a stack of blocks maps block by block, leading axis in front
    stacked = tanalog.map_tiled_vec(t(np.stack([a, -a])), torch.Generator(),
                                    tcfg, torch.tensor(scale))
    assert stacked.shape == (2, 2, 3, 8, 8)
    assert torch.equal(stacked.gpos[0], tg.gpos)
    assert torch.equal(stacked.gneg[1], tg.gpos)
    with pytest.raises(ValueError, match="multiples"):
        tanalog.map_tiled_vec(t(a[:, :20]), torch.Generator(), tcfg,
                              torch.tensor(scale))


def test_map_tiled_vec_noise_draw_order():
    """The positive stack's normals are drawn first, then the negative
    stack's, from the one generator."""
    tcfg = tanalog.AnalogConfig(array_size=8,
                                nonideal=tni.NonidealConfig(sigma=0.05))
    a = t(RNG.normal(size=(16, 16)).astype(np.float32))
    tg = tanalog.map_tiled_vec(a, torch.Generator().manual_seed(4), tcfg,
                               torch.tensor(1.0))
    gen = torch.Generator().manual_seed(4)
    n_pos = torch.randn((2, 2, 8, 8), generator=gen)
    tiles = a.reshape(2, 8, 2, 8).transpose(1, 2)
    want = torch.clamp_min(torch.clamp_min(tiles, 0.0) * G0
                           + 0.05 * G0 * n_pos, 0.0)
    close(tg.gpos, want, rtol=1e-6, atol=1e-12)


def test_sliced_mapping_at_sigma0_matches_jax():
    jcfg, tcfg = _cfgs({})
    a, v = _pair_inputs(8, 8, 3)
    jp = janalog.map_matrix_sliced(jnp.asarray(a), jax.random.PRNGKey(0),
                                   jcfg, jnp.float32(1.0), n_slices=3)
    tp = tanalog.map_matrix_sliced(t(a), torch.Generator(), tcfg,
                                   torch.tensor(1.0), n_slices=3)
    assert [w for _, w in tp] == [w for _, w in jp]
    for (tpair, _), (jpair, _) in zip(tp, jp):
        _rel(tpair.gpos, jpair.gpos)
        _rel(tpair.gneg, jpair.gneg)
    close(tanalog.amc_mvm_sliced(tp, t(v), tcfg),
          janalog.amc_mvm_sliced(jp, jnp.asarray(v), jcfg),
          rtol=1e-5, atol=1e-6)
