"""The port's recurrent blocks - RG-LRU (`repro_torch.models.rglru`) and
SSD (`repro_torch.models.ssm`) - and their architectures
(recurrentgemma-2b, mamba2-130m) against the JAX package, on a CPU host,
at `reduce_cfg` size (float32: d_model 64, RG-LRU width 64, local window
8; SSD state 16, head dim 8, chunks of 4).

The JAX package draws the weights; `repro_torch.interop` carries them
across; inputs are made with numpy from a seed and fed to both.

Tolerances:
  * block outputs and caches: 1e-5 relative, 1e-6 absolute - float32,
    the RG-LRU scan associated differently (`linear_scan` against
    `jax.lax.associative_scan`) and the SSD sums reordered; the gates'
    softplus is torch's (linear above 20), exact at the reference's
    lam = 2.0 init;
  * decode token by token, against the port's own forward and the
    reference's decode step for step: outputs and the last state within
    1e-5 of max|.| (the sequential recurrence against the scan or the
    chunked SSD, and the state's contractions, are other associations of
    the same float32 sums);
  * gradients: 1e-4 of max|g| per leaf;
  * whole models: `_torch_lm_parity`'s (2e-4; gradients 1e-4 of max|g|);
  * reset_slots: equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm_scheduler as jsched
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import lm_scheduler as tsched
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from tests.conftest import reduce_cfg
import _torch_lm_parity as lm
from _torch_parity import scaled_close

RG = "recurrentgemma-2b"
MAMBA = "mamba2-130m"


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(reduce_cfg(j_get_config(arch)), **kw)
    return jcfg, get_config(arch).__class__(**dataclasses.asdict(jcfg))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-6)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


MODULES = {"rglru": (jrglru.init_rglru, jrglru.rglru_forward,
                     trglru.rglru_forward, RG),
           "ssm": (jssm.init_ssm, jssm.ssm_forward, tssm.ssm_forward,
                   MAMBA)}


def _block(kind, seed=0, **kw):
    jinit, jfwd, tfwd, arch = MODULES[kind]
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = jinit(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if kind == "ssm":     # the reference's zeros / ones make the gates flat
        rng = np.random.default_rng(seed)
        jp = dict(jp, **{k: jnp.asarray(rng.normal(size=jp[k].shape) * 0.3,
                                        jnp.float32)
                         for k in ("a_log", "dt_bias", "norm_w")})
    return jcfg, tcfg, jp, interop.lm_params_from_numpy(lm.np_tree(jp),
                                                        device="cpu")


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(0)
    for s in (1, 2, 5, 16, 33):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 3)))
        b = torch.from_numpy(rng.normal(size=(2, s, 3)))
        h, hs = torch.zeros(2, 3, dtype=a.dtype), []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        torch.testing.assert_close(trglru.linear_scan(a, b),
                                   torch.stack(hs, 1), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("kind,s", [("rglru", 16), ("rglru", 13),
                                    ("ssm", 16), ("ssm", 4)])
def test_block_forward_and_cache_match_the_reference(kind, s):
    jcfg, tcfg, jp, tp = _block(kind)
    _, jfwd, tfwd, _ = MODULES[kind]
    x = _x((2, s, jcfg.d_model), 1)
    want, jcache = jfwd(jp, jnp.asarray(x), jcfg, return_cache=True)
    got, cache = tfwd(tp, torch.from_numpy(x), tcfg, return_cache=True)
    _close(got, want)
    assert sorted(cache) == sorted(jcache)
    for key in cache:
        _close(cache[key], jcache[key])
    _close(tfwd(tp, torch.from_numpy(x), tcfg), want)


@pytest.mark.parametrize("kind", ["rglru", "ssm"])
def test_decode_token_by_token_matches_the_forward(kind):
    """The recurrence one token at a time from a zeroed cache gives the
    forward's outputs and its last state, and equals the reference's
    decode step for step."""
    jcfg, tcfg, jp, tp = _block(kind, seed=1)
    _, _, tfwd, _ = MODULES[kind]
    x = _x((2, 12, jcfg.d_model), 2)
    full, last = tfwd(tp, torch.from_numpy(x), tcfg, return_cache=True)
    if kind == "rglru":
        cache = trglru.init_rglru_cache(2, tcfg, device="cpu")
        jcache = jrglru.init_rglru_cache(2, jcfg)
        tdec, jdec = trglru.rglru_decode, jrglru.rglru_decode
    else:
        cache = tssm.init_ssm_cache(2, tcfg, device="cpu")
        jcache = jssm.init_ssm_cache(2, jcfg)
        tdec, jdec = tssm.ssm_decode, jssm.ssm_decode
    for t in range(x.shape[1]):
        out, same = tdec(tp, torch.from_numpy(x[:, t:t + 1]), cache, tcfg)
        assert same is cache
        jout, jcache = jdec(jp, jnp.asarray(x[:, t:t + 1]), jcache, jcfg)
        scaled_close(out, full[:, t:t + 1], 1e-5)
        scaled_close(out, jout, 1e-5)
    for key in cache:
        scaled_close(cache[key], last[key], 1e-5)
        scaled_close(cache[key], jcache[key], 1e-5)


def test_rglru_gelu_is_the_tanh_approximation():
    """`jax.nn.gelu` defaults to the tanh approximation; the port's block
    uses it (torch's default, the exact erf form, differs by ~1e-3)."""
    x = torch.linspace(-4, 4, 101)
    want = np.array(jax.nn.gelu(jnp.asarray(x.numpy())))
    _close(torch.nn.functional.gelu(x, approximate="tanh"), want)
    assert float((torch.nn.functional.gelu(x) - torch.from_numpy(want))
                 .abs().max()) > 1e-4


@pytest.mark.parametrize("kind", ["rglru", "ssm"])
def test_block_gradient_matches_the_reference(kind):
    """d/d(params, x) of sum(w * out) through the scan (RG-LRU) and the
    chunked SSD (several chunks)."""
    jcfg, tcfg, jp, tp = _block(kind, seed=2)
    _, jfwd, tfwd, _ = MODULES[kind]
    x = _x((2, 16, jcfg.d_model), 3)
    w = _x((2, 16, jcfg.d_model), 4)
    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(jfwd(p, xx, jcfg) * w),
                        argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    torch.sum(tfwd(leaves, tx, tcfg) * torch.from_numpy(w)).backward()
    lm.grads_close({k: v.grad for k, v in leaves.items()}, lm.np_tree(jgp))
    lm.grads_close({"x": tx.grad}, {"x": np.asarray(jgx)})


def test_ssd_gradient_stays_finite_where_the_decay_overflows():
    """A chunk whose cumulative log-decay spans more than float32's range:
    exp(cum_i - cum_j) above the diagonal is inf.  The forward is finite
    in both packages (1e-4 of max|out|: outputs of a few units summed
    from inputs scaled by dt ~ 10); the port's gradient is finite too (the
    mask comes before the exponential), where the reference's meets
    0 * inf."""
    jcfg, tcfg, jp, tp = _block("ssm", seed=3, ssm_chunk=16)
    tp = dict(tp, a_log=torch.full_like(tp["a_log"], 4.0),
              dt_bias=torch.full_like(tp["dt_bias"], 10.0))
    jp = dict(jp, a_log=jnp.full_like(jp["a_log"], 4.0),
              dt_bias=jnp.full_like(jp["dt_bias"], 10.0))
    x = _x((1, 16, jcfg.d_model), 5)
    out = tssm.ssm_forward(tp, torch.from_numpy(x), tcfg)
    assert bool(torch.isfinite(out).all())
    scaled_close(out, jssm.ssm_forward(jp, jnp.asarray(x), jcfg), 1e-4)
    leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
    tssm.ssm_forward(leaves, torch.from_numpy(x), tcfg).sum().backward()
    assert all(bool(torch.isfinite(v.grad).all()) for v in leaves.values())
    jg = jax.grad(lambda p: jnp.sum(jssm.ssm_forward(p, jnp.asarray(x),
                                                     jcfg)))(jp)
    assert not all(bool(jnp.isfinite(v).all()) for v in jg.values())


def test_reset_slots_zeroes_recurrent_states_like_the_reference():
    """A hybrid cache (RG-LRU states, conv histories, windowed KV rings)
    and an SSM cache: the masked slots' states are zeroed on the batch
    axis of every leaf, in place, as the reference's."""
    for arch in (RG, MAMBA):
        jcfg, tcfg = _cfgs(arch)
        jcache = jtr.init_cache(3, 8, jcfg, dtype=jnp.float32)
        rng = np.random.default_rng(6)
        filled = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), jcache)
        mask = np.array([False, True, False])
        want = jsched.reset_slots(jax.tree.map(jnp.asarray, filled),
                                  jnp.asarray(mask))
        tcache = interop.lm_cache_from_numpy(filled, device="cpu")
        got = tsched.reset_slots(tcache, torch.from_numpy(mask))
        assert got is tcache
        lm.trees_close(got, lm.np_tree(want), 0)


@pytest.mark.parametrize("check", ["init_layout", "forward", "train_step",
                                   "prefill_then_decode",
                                   "decode_from_zero_cache"])
@pytest.mark.parametrize("arch", [RG, MAMBA])
def test_recurrent_architecture_matches_the_reference(arch, check):
    """recurrentgemma's reduced window (8) is shorter than the 16-token
    prompt, so its attention ring buffers wrap in the prefill."""
    getattr(lm, f"check_{check}")(arch)


def test_continuous_batching_serves_a_hybrid_model_like_the_reference():
    """Slots re-admitted mid-run zero their RG-LRU states
    (`reset_slots`): every request's greedy ids equal the reference's."""
    jcfg, tcfg, jparams, tparams = lm.carried(RG)
    rng = np.random.default_rng(7)
    reqs = [(i, rng.integers(0, 512, size=n).tolist(), m)
            for i, (n, m) in enumerate([(3, 4), (6, 2), (1, 5), (4, 3)])]
    want = jsched.ContinuousBatchingEngine(jcfg, jparams, n_slots=2,
                                           max_len=12).run(
        [jsched.Request(*r) for r in reqs])
    got = tsched.ContinuousBatchingEngine(tcfg, tparams, n_slots=2,
                                          max_len=12).run(
        [tsched.Request(*r) for r in reqs])
    assert got == want
