"""Whole-model parity checks shared by the language-model block tests: one
architecture at `reduce_cfg` size, its weights drawn by the JAX package
and carried across with `repro_torch.interop`, through the forward, a
train step and decode in both packages (the checks of
`test_models_smoke.py`, held to the reference's numbers).

Tolerances: logits, caches and losses at 2e-4 (rtol and atol), the
reference's in-model tolerance (float32 sums in another order through
several layers); gradients 1e-4 of max|g| per leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jtr
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import transformer as ttr
from repro_torch.train import train_step as tts
from tests.conftest import reduce_cfg

TOL = 2e-4
B, S = 2, 16


def cfgs(arch, **overrides):
    """The reduced config in both packages (same field values)."""
    jcfg = reduce_cfg(j_get_config(arch), **overrides)
    return jcfg, get_config(arch).__class__(**dataclasses.asdict(jcfg))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(actual, expected, tol=TOL):
    np.testing.assert_allclose(np.asarray(actual, np.float32),
                               np.asarray(expected, np.float32),
                               rtol=tol, atol=tol)


def pairs(got, want, prefix=""):
    assert sorted(got) == sorted(want), prefix
    for key in sorted(want):
        if isinstance(want[key], dict):
            yield from pairs(got[key], want[key], f"{prefix}/{key}")
        else:
            yield f"{prefix}/{key}", got[key], want[key]


def trees_close(got, want, tol=TOL):
    for key, g, w in pairs(got, want):
        assert tuple(g.shape) == tuple(np.shape(w)), key
        close(g, w, tol)


def grads_close(got, want, rel=1e-4):
    for key, g, w in pairs(got, want):
        w = np.asarray(w, np.float32)
        bound = rel * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= bound, f"{key}: max abs err {err:.3g} > {bound:.3g}"


def carried(arch, **overrides):
    """(jcfg, tcfg, JAX params, the port's params on the host)."""
    jcfg, tcfg = cfgs(arch, **overrides)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, interop.lm_params_from_numpy(
        np_tree(jparams), device="cpu")


def tokens(seed=1, shape=(B, S), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def check_init_layout(arch):
    """The port's own `init_params` gives the carried tree's keys, shapes
    and dtypes, and every leaf is finite."""
    _, tcfg, _, tparams = carried(arch)
    own = ttr.init_params(torch.Generator().manual_seed(0), tcfg)

    def shapes(tree):
        return {k: (shapes(v) if isinstance(v, dict) else
                    (tuple(v.shape), v.dtype)) for k, v in tree.items()}
    assert shapes(own) == shapes(tparams)
    for _, leaf, _ in pairs(own, own):
        assert bool(torch.isfinite(leaf).all())


def check_forward(arch):
    jcfg, tcfg, jparams, tparams = carried(arch)
    toks = tokens()
    want, jaux = jtr.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    got, aux = ttr.forward(tparams, tcfg, tokens=torch.from_numpy(toks))
    assert got.shape == (B, S, ttr.padded_vocab(tcfg))
    close(got, want)
    close(aux, jaux)


def check_train_step(arch):
    """The loss (cross entropy + the MoE aux term) and every gradient of
    one step's `value_and_grad`, remat "dots" as the smoke test's step."""
    jcfg, tcfg, jparams, tparams = carried(arch)
    toks = tokens(seed=2)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p, b: jts.loss_fn(p, b, jcfg, "dots"), has_aux=True)(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met, grads = tts.value_and_grad(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
        "dots")
    assert bool(torch.isfinite(loss))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    close(met["aux"], jmet["aux"])
    grads_close(grads, jgrads)


def check_prefill_then_decode(arch, cache_len=32, steps=4):
    """`prefill` of S tokens, then `decode_step` token by token: logits
    and the whole cache against the reference's at every step."""
    jcfg, tcfg, jparams, tparams = carried(arch)
    toks = tokens(seed=3, shape=(B, S + steps))
    jlast, jcache = jtr.prefill(jparams, jcfg, tokens=jnp.asarray(toks[:, :S]),
                                cache_len=cache_len, cache_dtype=jnp.float32)
    last, cache = ttr.prefill(tparams, tcfg,
                              tokens=torch.from_numpy(toks[:, :S]),
                              cache_len=cache_len, cache_dtype=torch.float32)
    close(last, jlast)
    trees_close(cache, np_tree(jcache))
    step = jax.jit(lambda p, c, tk, ps: jtr.decode_step(p, c, tk, ps, jcfg))
    for t in range(S, S + steps):
        want, jcache = step(jparams, jcache, jnp.asarray(toks[:, t]),
                            jnp.int32(t))
        got, out_cache = ttr.decode_step(tparams, cache,
                                         torch.from_numpy(toks[:, t]), t,
                                         tcfg)
        assert out_cache is cache                  # updated in place
        close(got, want)
    trees_close(cache, np_tree(jcache))


def check_decode_from_zero_cache(arch):
    """The smoke test's decode: one step from `init_cache` at position 0,
    the cache's layout equal to the reference's."""
    jcfg, tcfg, jparams, tparams = carried(arch)
    jcache = jtr.init_cache(B, 32, jcfg, dtype=jnp.float32)
    cache = ttr.init_cache(B, 32, tcfg, dtype=torch.float32, device="cpu")
    trees_close(cache, np_tree(jcache), 0)
    toks = tokens(seed=4, shape=(B,))
    want, jcache = jtr.decode_step(jparams, jcache, jnp.asarray(toks),
                                   jnp.int32(0), jcfg)
    got, cache = ttr.decode_step(tparams, cache, torch.from_numpy(toks), 0,
                                 tcfg)
    close(got, want)
    trees_close(cache, np_tree(jcache))
