"""The port's language-model serving path (`repro_torch.models`) against the
JAX package, on a CPU host, at `reduce_cfg(get_config("glm4-9b"))`
(float32: 4 layers, d_model 64, 4 heads, 2 KV heads, head_dim 16).

Random weights cannot be replayed across frameworks, so the JAX package
draws them (`init_params`) and `repro_torch.interop.lm_params_from_numpy`
carries them across; every other input is made with numpy from a seed and
fed to both.  On the CPU the port's flash route runs the kernel's plain
version (`kernels/ref.py`); the JAX side runs its Pallas kernel in
interpret mode.

Tolerances:
  * layers (rms_norm, rope, swiglu_ffn): atol 1e-6 - the same float32
    arithmetic, elementwise or one matmul;
  * attention, decode, forward, prefill (logits and cache): rtol/atol
    2e-4, the reference's own in-model tolerance
    (`test_kernels.py::test_flash_attention_in_model_layer`) - float32
    sums in another order, through softmax and several layers;
  * greedy ids (Engine.generate, ContinuousBatchingEngine.run): equal;
  * reset_slots, config data: equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.launch.train import host_scale_config as j_host_scale
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm_scheduler as jsched
from repro.models import transformer as jtr
from repro.models.lm_engine import Engine as JEngine
from repro_torch import interop
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.train import host_scale_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm_scheduler as tsched
from repro_torch.models import transformer as ttr
from repro_torch.models.lm_engine import Engine
from repro_torch.tree import tree_map
from tests.conftest import reduce_cfg

TOL = 2e-4
B, S = 2, 12


def _cfgs():
    """The reduced glm4-9b in both packages (same field values)."""
    jcfg = reduce_cfg(j_get_config("glm4-9b"))
    return jcfg, get_config("glm4-9b").__class__(**dataclasses.asdict(jcfg))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(actual, expected, tol=TOL):
    np.testing.assert_allclose(np.asarray(actual, np.float32),
                               np.asarray(expected, np.float32),
                               rtol=tol, atol=tol)


def _trees_close(actual, expected, tol=TOL):
    assert sorted(actual) == sorted(expected)
    for key in expected:
        if isinstance(expected[key], dict):
            _trees_close(actual[key], expected[key], tol)
        else:
            _close(actual[key], expected[key], tol)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = interop.lm_params_from_numpy(_np_tree(jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(seed=1, shape=(B, S), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


# ------------------------------- configs -----------------------------------

def test_configs_and_host_scale_match_the_reference():
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for name, jcfg in J_ARCHS.items():
        assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(host_scale_config(ARCHS[name])) == \
            dataclasses.asdict(j_host_scale(jcfg))
        assert ttr.stack_layout(ARCHS[name]) == jtr.stack_layout(jcfg)
        assert ttr.padded_vocab(ARCHS[name]) == jtr.padded_vocab(jcfg)


def test_params_carry_across_key_for_key(model):
    jcfg, tcfg, jparams, tparams = model
    own = ttr.init_params(torch.Generator().manual_seed(0), tcfg)

    def shapes(tree):
        return {k: (shapes(v) if isinstance(v, dict) else
                    (tuple(v.shape), str(v.dtype).split(".")[-1]))
                for k, v in tree.items()}
    assert shapes(own) == shapes(tparams)
    assert tparams["blocks"]["b0"]["mix"]["wq"].shape[0] == tcfg.n_layers


def test_bfloat16_leaves_carry_bit_for_bit():
    x = jax.random.normal(jax.random.PRNGKey(2), (3, 5)).astype(jnp.bfloat16)
    tree = {"blocks": {"w": np.asarray(x)}, "ln": np.ones(4, np.float32)}
    out = interop.lm_cache_from_numpy(tree, device="cpu")
    assert out["blocks"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["blocks"]["w"].view(torch.int16).numpy(),
        np.asarray(x).view(np.int16))
    assert out["ln"].dtype == torch.float32


# ------------------------------- layers ------------------------------------

def test_rms_norm_rope_swiglu_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    w = rng.normal(size=16).astype(np.float32) * 0.1
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), 1e-6)
    pos = np.stack([np.arange(7), np.arange(5, 12)]).astype(np.int32)
    _close(tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-6)
    h = rng.normal(size=(2, 7, 64)).astype(np.float32)
    p = {k: (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
         for k, shape in (("gate", (64, 128)), ("up", (64, 128)),
                          ("down", (128, 64)))}
    _close(tlayers.swiglu_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(h)),
           jlayers.swiglu_ffn({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(h)), 1e-6)
    logits = rng.normal(size=(3, 9)).astype(np.float32) * 50
    _close(tlayers.softcap(torch.from_numpy(logits), 30.0),
           jlayers.softcap(jnp.asarray(logits), 30.0), 1e-6)


# ------------------------------ attention ----------------------------------

def _attn_inputs(model, s=S, seed=3):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy()
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["b0"]["mix"])
    tp = {k: v[0] for k, v in tparams["blocks"]["b0"]["mix"].items()}
    return jcfg, tcfg, jp, tp, x, pos


@pytest.mark.parametrize("t_flash", [False, None, True])
@pytest.mark.parametrize("j_flash", [False, True])
def test_attention_routes_match_the_reference(model, t_flash, j_flash):
    jcfg, tcfg, jp, tp, x, pos = _attn_inputs(model)
    want = jattn.attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                           use_flash=j_flash)
    got = tattn.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                          tcfg, use_flash=t_flash)
    _close(got, want)


def test_attention_window_route(model):
    jcfg, tcfg, jp, tp, x, pos = _attn_inputs(model)
    want = jattn.attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                           window=4, q_chunk=4)
    got = tattn.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                          tcfg, window=4, q_chunk=4)      # None: chunked
    _close(got, want)
    with pytest.raises(ValueError, match="sliding"):
        tattn.attention(tp, torch.from_numpy(x), torch.from_numpy(pos), tcfg,
                        window=4, use_flash=True)


@pytest.mark.parametrize("head_dim,dtype", [
    (96, torch.float32), (256, torch.float32), (96, torch.bfloat16),
    (256, torch.bfloat16), (64, torch.float16), (128, torch.float16)])
def test_flash_route_takes_the_chunked_path_where_the_kernel_lacks_the_case(
        head_dim, dtype):
    """On the card (`on_card=True`) the default route takes the chunked
    path for a head dim or dtype the attention kernel has no instance for,
    as for a sliding window, and `use_flash=True` there raises."""
    assert not tattn._flash_route(None, None, head_dim, dtype, True)
    assert not tattn._flash_route(False, None, head_dim, dtype, True)
    with pytest.raises(ValueError, match="flash kernel takes no"):
        tattn._flash_route(True, None, head_dim, dtype, True)


def test_flash_route_keeps_the_kernels_cases():
    """The kernel's cases take the flash route on the card; on the host
    its plain version takes any head dim (float16 has no flash route
    anywhere, a sliding window none either)."""
    for head_dim in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            assert tattn._flash_route(None, None, head_dim, dtype, True)
            assert tattn._flash_route(True, None, head_dim, dtype, True)
    assert tattn._flash_route(None, None, 16, torch.float32, False)
    assert tattn._flash_route(True, None, 96, torch.float32, False)
    assert not tattn._flash_route(None, None, 64, torch.float16, False)
    assert not tattn._flash_route(None, 4, 64, torch.float32, True)
    with pytest.raises(ValueError, match="sliding window"):
        tattn._flash_route(True, 4, 64, torch.float32, False)


def test_float16_attention_computes_on_the_default_route(model):
    """float16 activations, which the flash route refuses, take the
    chunked path by default and match the reference's default (chunked)
    attention in float16: 1e-2, float16's rounding through softmax."""
    jcfg, tcfg, jp, tp, x, pos = _attn_inputs(model)
    want = jattn.attention(jax.tree.map(lambda a: a.astype(jnp.float16), jp),
                           jnp.asarray(x, jnp.float16), jnp.asarray(pos),
                           jcfg)
    got = tattn.attention({k: v.half() for k, v in tp.items()},
                          torch.from_numpy(x).half(), torch.from_numpy(pos),
                          tcfg)
    assert got.dtype == torch.float16
    _close(got.float(), np.asarray(want, np.float32), 1e-2)


@pytest.mark.parametrize("window,cache_len", [(None, 16), (4, 4), (8, 8)])
def test_attention_prefill_cache_matches(model, window, cache_len):
    jcfg, tcfg, jp, tp, x, pos = _attn_inputs(model)
    jo, jc = jattn.attention_prefill(jp, jnp.asarray(x), jnp.asarray(pos),
                                     jcfg, cache_len, window=window,
                                     cache_dtype=jnp.float32)
    to, tc = tattn.attention_prefill(tp, torch.from_numpy(x),
                                     torch.from_numpy(pos), tcfg, cache_len,
                                     window=window, cache_dtype=torch.float32)
    _close(to, jo)
    _trees_close(tc, _np_tree(jc))


@pytest.mark.parametrize("window,cache_len,pos", [
    (None, 16, [3, 11]),        # per-slot positions
    (None, 16, 5),              # one shared position
    (4, 4, [2, 9]),             # ring buffer: not yet wrapped / wrapped
])
def test_attention_decode_matches(model, window, cache_len, pos):
    jcfg, tcfg, jp, tp, _, _ = _attn_inputs(model)
    rng = np.random.default_rng(4)
    x_t = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    shape = (B, cache_len, jcfg.kv_heads, jcfg.head_dim)
    cache = {"k": rng.normal(size=shape).astype(np.float32),
             "v": rng.normal(size=shape).astype(np.float32)}
    jpos = jnp.asarray(pos, jnp.int32)
    jo, jc = jattn.attention_decode(jp, jnp.asarray(x_t),
                                    jax.tree.map(jnp.asarray, cache), jpos,
                                    jcfg, window=window)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    to, tc = tattn.attention_decode(tp, torch.from_numpy(x_t), tcache,
                                    torch.tensor(pos), tcfg, window=window)
    _close(to, jo)
    _trees_close(tc, _np_tree(jc))
    assert tc["k"] is tcache["k"]                 # written in place


# ------------------------------ the model ----------------------------------

@pytest.mark.parametrize("use_flash", [None, False])
def test_forward_logits_match(model, use_flash):
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens()
    want, jaux = jtr.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    got, aux = ttr.forward(tparams, tcfg, tokens=torch.from_numpy(toks),
                           use_flash=use_flash)
    assert got.shape == (B, S, ttr.padded_vocab(tcfg))
    _close(got, want)
    assert float(aux) == float(jaux) == 0.0


def test_forward_window_override_takes_the_chunked_route(model):
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(seed=2)
    want, _ = jtr.forward(jparams, jcfg, tokens=jnp.asarray(toks),
                          window_override=4)
    got, _ = ttr.forward(tparams, tcfg, tokens=torch.from_numpy(toks),
                         window_override=4)
    _close(got, want)


@pytest.mark.parametrize("use_flash", [None, False])
def test_prefill_logits_and_cache_match(model, use_flash):
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens()
    want, jcache = jtr.prefill(jparams, jcfg, tokens=jnp.asarray(toks),
                               cache_len=S + 4, cache_dtype=jnp.float32)
    got, cache = ttr.prefill(tparams, tcfg, tokens=torch.from_numpy(toks),
                             cache_len=S + 4, cache_dtype=torch.float32,
                             use_flash=use_flash)
    _close(got, want)
    _trees_close(cache, _np_tree(jcache))


def test_decode_step_over_twelve_tokens(model):
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(seed=5)
    jcache = jtr.init_cache(B, S, jcfg, dtype=jnp.float32)
    tcache = ttr.init_cache(B, S, tcfg, dtype=torch.float32, device="cpu")
    step = jax.jit(lambda p, c, tk, ps: jtr.decode_step(p, c, tk, ps, jcfg))
    for t in range(S):
        want, jcache = step(jparams, jcache, jnp.asarray(toks[:, t]),
                            jnp.int32(t))
        got, tcache = ttr.decode_step(tparams, tcache,
                                      torch.from_numpy(toks[:, t]), t, tcfg)
        _close(got, want)
    _trees_close(tcache, _np_tree(jcache))


def test_engine_generate_greedy_ids_equal(model):
    jcfg, tcfg, jparams, tparams = model
    prompts = _tokens(seed=3, shape=(B, 8))
    want = np.asarray(JEngine(jcfg, jparams, max_len=32).generate(
        jnp.asarray(prompts), 6))
    eng = Engine(tcfg, tparams, max_len=32)
    got = eng.generate(torch.from_numpy(prompts), 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        eng.generate(torch.from_numpy(prompts), 6).numpy(), want)
    # eos freezing, at an id the greedy run produces mid-sequence
    eos = int(want[0, 2])
    want_eos = np.asarray(JEngine(jcfg, jparams, max_len=32, eos_id=eos)
                          .generate(jnp.asarray(prompts), 6))
    got_eos = Engine(tcfg, tparams, max_len=32, eos_id=eos).generate(
        torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(got_eos.numpy(), want_eos)
    assert (want_eos[0, 3:] == eos).all()


def test_engine_samples_with_the_callers_generator(model):
    _, tcfg, _, tparams = model
    prompts = torch.from_numpy(_tokens(seed=3, shape=(B, 8)))
    eng = Engine(tcfg, tparams, max_len=32, temperature=0.8)
    a = eng.generate(prompts, 6, torch.Generator().manual_seed(7))
    b = eng.generate(prompts, 6, torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bool(((a >= 0) & (a < ttr.padded_vocab(tcfg))).all())


def test_continuous_batching_per_request_equal(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(6)
    reqs = [(i, rng.integers(0, 512, size=n).tolist(), m)
            for i, (n, m) in enumerate([(3, 4), (6, 2), (1, 5), (4, 3),
                                        (2, 6)])]
    want = jsched.ContinuousBatchingEngine(jcfg, jparams, n_slots=2,
                                           max_len=12).run(
        [jsched.Request(*r) for r in reqs])
    got = tsched.ContinuousBatchingEngine(tcfg, tparams, n_slots=2,
                                          max_len=12).run(
        [tsched.Request(*r) for r in reqs])
    assert got == want
    assert all(len(got[i]) == m for i, _, m in reqs)


def test_reset_slots_matches(model):
    jcfg, tcfg, _, _ = model
    jcache = jtr.init_cache(3, 5, jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(8)
    filled = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), jcache)
    mask = np.array([False, True, False])
    want = jsched.reset_slots(jax.tree.map(jnp.asarray, filled),
                              jnp.asarray(mask))
    tcache = interop.lm_cache_from_numpy(filled, device="cpu")
    got = tsched.reset_slots(tcache, torch.from_numpy(mask))
    assert got is tcache
    _trees_close(got, _np_tree(want), 0)
    assert float(got["blocks"]["b0"]["k"][:, 1].abs().max()) == 0.0


def test_remat_other_than_none_raises(model):
    """"none", "dots" and "full" are the reference's remat modes (the
    training tests hold all three to it); any other raises."""
    _, tcfg, _, tparams = model
    toks = torch.zeros((1, 4), dtype=torch.long)
    for remat in ("dots", "full"):
        logits, _ = ttr.forward(tparams, tcfg, tokens=toks, remat=remat)
        assert torch.equal(logits, ttr.forward(tparams, tcfg,
                                               tokens=toks)[0])
    with pytest.raises(ValueError, match="remat"):
        ttr.forward(tparams, tcfg, tokens=toks, remat="offload")


def test_default_route_takes_the_chunked_path_under_autograd(model,
                                                            monkeypatch):
    """The default route never reaches the flash wrapper while autograd
    records through q, k or v (its kernel runs outside autograd, on the
    card as here), and reaches it once a layer under no_grad;
    use_flash=True under grad recording raises."""
    _, tcfg, _, tparams = model
    calls = []
    flash = tattn.kops.flash_attention

    def counted(*args, **kw):
        calls.append(1)
        return flash(*args, **kw)
    monkeypatch.setattr(tattn.kops, "flash_attention", counted)
    toks = torch.from_numpy(_tokens().astype(np.int64))
    diff = {k: v for k, v in tparams.items()}
    diff["blocks"] = tree_map(lambda p: p.detach().requires_grad_(),
                              tparams["blocks"])
    logits, _ = ttr.forward(diff, tcfg, tokens=toks)
    logits.sum().backward()
    assert len(calls) == 0
    assert diff["blocks"]["b0"]["mix"]["wq"].grad.abs().max() > 0
    with torch.no_grad():
        kernel_route, _ = ttr.forward(diff, tcfg, tokens=toks)
    assert len(calls) == tcfg.n_layers
    _close(kernel_route, logits.detach())
    with pytest.raises(ValueError, match="gradient"):
        ttr.forward(diff, tcfg, tokens=toks, use_flash=True)


def test_serve_launcher_runs_on_the_host():
    from repro_torch.launch import serve
    out = serve.main(["--arch", "glm4-9b", "--host-scale", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    assert tuple(out.shape) == (2, 4)
    assert bool(((out >= 0) & (out < 2048)).all())


@pytest.mark.parametrize("build", [
    lambda cfg: ttr.init_cache(1, 4, cfg),
    lambda cfg: ttr.init_block_cache(1, 4, cfg, "attn"),
    lambda cfg: tattn.init_kv_cache(1, 4, cfg),
], ids=["init_cache", "init_block_cache", "init_kv_cache"])
def test_cache_builders_default_to_the_card(build):
    """As every entry point of the port: the card by default, and a loud
    failure without one rather than a cache on the host."""
    _, tcfg = _cfgs()
    if torch.cuda.is_available():
        cache = build(tcfg)
        leaves = [cache["k"]] if "k" in cache else \
            [x for blk in cache["blocks"].values() for x in blk.values()]
        assert all(x.device.type == "cuda" for x in leaves)
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            build(tcfg)
