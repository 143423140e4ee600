"""The port's optimizers (`repro_torch.optim`) against the JAX package, on
a CPU host: the LR schedule, AdamW, int8 gradient compression and the
BlockAMC preconditioner.  Inputs are made with numpy from a seed and fed
to both packages.

Tolerances:
  * `warmup_cosine`: equal (the same float32 operations);
  * AdamW: 1e-6 relative (the same float32 arithmetic; `b ** step` may
    round differently in its last bit), bfloat16 moments included;
  * int8 codes and scales: equal;
  * the digital preconditioner: 1e-5 of max|out| (the same recursion of
    float32 GEMMs, its sums reassociated); the analog one at an ideal
    config: 1e-4 of max|out| (programming, the cascade and four CG
    iterations, each in float32); a noisy one (sigma 0.05) within 0.05
    relative of the digital one, the reference's own acceptance
    (`tests/test_optim_runtime.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import grad_compression as jgc
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.blockamc_precond import BlockAMCPrecond as JPrecond
from repro.optim.schedule import warmup_cosine as j_warmup_cosine
from repro_torch import interop
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.nonideal import NonidealConfig
from repro_torch.optim import grad_compression as tgc
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.blockamc_precond import BlockAMCPrecond
from repro_torch.optim.schedule import warmup_cosine
from _torch_parity import scaled_close


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------ schedule ----------------------------------

@pytest.mark.parametrize("kw", [{}, dict(warmup=100, total=1000),
                                dict(warmup=0, total=7, floor=0.25)],
                         ids=["default", "short", "no_warmup"])
def test_warmup_cosine_equals_the_reference(kw):
    steps = [0, 1, 2, 7, 50, 99, 100, 101, 199, 200, 201, 555, 1000, 4321,
             9999, 10000, 20000]
    want = np.asarray(j_warmup_cosine(jnp.asarray(steps, jnp.int32), **kw))
    got = warmup_cosine(torch.tensor(steps, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    for s in steps:                         # Python ints, one at a time
        assert float(warmup_cosine(s, **kw)) == \
            float(j_warmup_cosine(s, **kw))


def test_schedule_shape():
    assert float(warmup_cosine(0, warmup=100, total=1000)) == \
        pytest.approx(0.01)
    assert float(warmup_cosine(100, warmup=100, total=1000)) == \
        pytest.approx(1.0)
    assert float(warmup_cosine(1000, warmup=100, total=1000)) == \
        pytest.approx(0.1)


# ------------------------------- AdamW ------------------------------------

def _adam_tree(seed):
    rng = _rng(seed)
    return {"w": rng.normal(size=(8, 16)).astype(np.float32),
            "blk": {"b": rng.normal(size=(16,)).astype(np.float32),
                    "m3": rng.normal(size=(2, 4, 5)).astype(np.float32)}}


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    return fn(tree)


def _pairs(got, want, prefix=""):
    """(key, port leaf, reference leaf) over two nested dicts."""
    assert sorted(got) == sorted(want), (prefix, sorted(got), sorted(want))
    for key in sorted(want):
        if isinstance(want[key], dict):
            yield from _pairs(got[key], want[key], f"{prefix}/{key}")
        else:
            yield f"{prefix}/{key}", got[key], want[key]


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(moments):
    jopt = JAdamW(lr=1e-2, moments_dtype=getattr(jnp, moments))
    topt = AdamW(lr=1e-2, moments_dtype=getattr(torch, moments))
    params = _adam_tree(0)
    jp, tp = _tmap(jnp.asarray, params), _tmap(torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for i in range(3):
        grads = _adam_tree(10 + i)
        jp, js = jopt.update(_tmap(jnp.asarray, grads), js, jp,
                             lr_scale=jnp.float32(0.7))
        tp, ts = topt.update(_tmap(torch.from_numpy, grads), ts, tp,
                             lr_scale=torch.tensor(0.7))
    assert int(ts.step) == 3
    for tree_t, tree_j in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for key, got, want in _pairs(tree_t, tree_j):
            assert str(got.dtype).split(".")[-1] == str(want.dtype), key
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=1e-6, atol=1e-7, err_msg=key)


def test_adamw_leaves_its_arguments_and_decays_matrices_only():
    opt = AdamW(lr=0.1, weight_decay=0.5)
    params = {"w": torch.ones((2, 2)), "b": torch.ones(2)}
    state = opt.init(params)
    zero = {"w": torch.zeros((2, 2)), "b": torch.zeros(2)}
    new_p, new_s = opt.update(zero, state, params)
    assert torch.equal(params["w"], torch.ones((2, 2)))   # not in place
    assert int(state.step) == 0 and int(new_s.step) == 1
    assert torch.allclose(new_p["w"], torch.full((2, 2), 0.95))
    assert torch.equal(new_p["b"], torch.ones(2))


def test_adamw_converges_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}          # d/dw ||w||^2
        params, state = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_bf16_moments():
    opt = AdamW(lr=1e-2, moments_dtype=torch.bfloat16)
    params = {"w": torch.ones((4, 4))}
    state = opt.init(params)
    assert state.m["w"].dtype == torch.bfloat16
    new_p, new_s = opt.update({"w": torch.ones((4, 4))}, state, params)
    assert new_s.v["w"].dtype == torch.bfloat16
    assert bool(torch.isfinite(new_p["w"]).all())


# -------------------------- grad compression -------------------------------

@pytest.mark.parametrize("shape,scale", [((1000,), 1.0), ((37, 29), 1e-3),
                                         ((4, 5, 6), 300.0)])
def test_int8_codes_and_scales_equal_the_reference(shape, scale):
    x = (_rng(3).normal(size=shape) * scale).astype(np.float32)
    jq, js = jgc.quantize_int8(jnp.asarray(x))
    tq, ts = tgc.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(tgc.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jgc.dequantize_int8(jq, js)))


def test_int8_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])   # scale ~ 1
    q, s = tgc.quantize_int8(x)
    jq, _ = jgc.quantize_int8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_int8_roundtrip_error_bounded():
    x = torch.from_numpy(_rng(0).normal(size=1000).astype(np.float32))
    q, s = tgc.quantize_int8(x)
    err = (tgc.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-7


def test_error_feedback_matches_the_reference_and_stays_unbiased():
    """With error feedback the accumulated compressed sum tracks the true
    sum; the port's residuals follow the reference's step for step."""
    x = (0.01 * _rng(1).normal(size=512)).astype(np.float32)
    err = tgc.init_error_state({"g": torch.from_numpy(x)})["g"]
    assert err.dtype == torch.float32 and float(err.abs().max()) == 0.0
    jerr = jgc.init_error_state({"g": jnp.asarray(x)})["g"]
    acc = torch.zeros(512)
    xt = torch.from_numpy(x)
    for _ in range(50):
        g32 = xt + err
        q, s = tgc.quantize_int8(g32)
        deq = tgc.dequantize_int8(q, s)
        err = g32 - deq
        acc = acc + deq
        jg = jnp.asarray(x) + jerr
        jq, js = jgc.quantize_int8(jg)
        jerr = jg - jgc.dequantize_int8(jq, js)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-9)
    rel = float(torch.linalg.norm(acc - 50 * xt) / torch.linalg.norm(50 * xt))
    assert rel < 0.02


# ---------------------- the BlockAMC preconditioner ------------------------

def _grads(seed, shape):
    return _rng(seed).normal(size=shape).astype(np.float32)


def _both(jpre, tpre, g):
    """Init, one statistics update and one refresh in both packages, then
    the preconditioned gradient; the port starts from the reference's
    state carried across (`interop.precond_state_from_numpy`)."""
    params = {"w": np.zeros(g.shape, np.float32),
              "v": np.zeros((3,), np.float32)}
    jstate = jpre.init(_tmap(jnp.asarray, params))
    tstate = tpre.init(_tmap(torch.from_numpy, params))
    carried = interop.precond_state_from_numpy(
        jax.tree.map(np.asarray, jstate), device="cpu")
    for key, got, want in _pairs(tstate.gram, carried.gram):
        np.testing.assert_array_equal(got.numpy(), want.numpy(), key)
    for key, got, want in _pairs(tstate.inv, carried.inv):
        np.testing.assert_array_equal(got.numpy(), want.numpy(), key)
    grads = {"w": g, "v": np.ones(3, np.float32)}
    jstate = jpre.refresh_inverses(
        jpre.update_stats(_tmap(jnp.asarray, grads), jstate))
    tstate = tpre.refresh_inverses(
        tpre.update_stats(_tmap(torch.from_numpy, grads), carried))
    assert int(tstate.step) == int(jstate.step) == 1
    jout = jpre.precondition(_tmap(jnp.asarray, grads), jstate)
    tout = tpre.precondition(_tmap(torch.from_numpy, grads), tstate)
    np.testing.assert_array_equal(tout["v"].numpy(), np.ones(3))
    return tout["w"].numpy(), np.asarray(jout["w"])


@pytest.mark.parametrize("shape,leaf", [((16, 32), 8), ((40, 24), 8)])
def test_digital_precond_matches_the_reference(shape, leaf):
    kw = dict(damping=1e-2, leaf_size=leaf, max_dim=64)
    got, want = _both(JPrecond(**kw), BlockAMCPrecond(**kw),
                      _grads(0, shape))
    scaled_close(got, want, 1e-5)


def test_ideal_analog_precond_matches_the_reference():
    kw = dict(damping=5e-2, leaf_size=8, max_dim=64, use_analog=True,
              refine_iters=8)
    jpre = JPrecond(**kw)
    tpre = BlockAMCPrecond(**kw)
    got, want = _both(jpre, tpre, _grads(1, (16, 16)))
    scaled_close(got, want, 1e-4)


def test_noisy_analog_precond_close_to_digital():
    """sigma 0.05 programming, its noise drawn by the port: the fixed CG
    budget brings the analog inverse root within 0.05 of the digital."""
    kw = dict(damping=5e-2, leaf_size=8, max_dim=64)
    noisy = AnalogConfig(array_size=8,
                         nonideal=NonidealConfig(sigma=0.05))
    g = torch.from_numpy(_grads(1, (16, 16)))
    outs = []
    for pre in (BlockAMCPrecond(**kw),
                BlockAMCPrecond(**kw, use_analog=True, refine_iters=8,
                                analog_cfg=noisy)):
        state = pre.update_stats({"w": g}, pre.init({"w": g}))
        outs.append(pre.precondition({"w": g},
                                     pre.refresh_inverses(state))["w"])
    rel = float(torch.linalg.norm(outs[1] - outs[0])
                / torch.linalg.norm(outs[0]))
    assert rel < 0.05


def test_precond_matches_direct_inverse_root():
    pre = BlockAMCPrecond(damping=1e-2, leaf_size=8, max_dim=64)
    g = torch.from_numpy(_grads(4, (16, 32)))
    state = pre.update_stats({"w": g}, pre.init({"w": torch.zeros(16, 32)}))
    out = pre.precondition({"w": g}, pre.refresh_inverses(state))["w"]
    gram = 0.95 * torch.eye(32) * 1e-2 + 0.05 * (g.T @ g) / 16
    evals, evecs = torch.linalg.eigh((gram + 1e-2 * torch.eye(32)).double())
    expect = g.double() @ ((evecs / evals.sqrt()) @ evecs.T)
    np.testing.assert_allclose(out.numpy(), expect.numpy(), rtol=2e-2,
                               atol=1e-3)


def test_precond_accelerates_illconditioned_quadratic():
    """Minimise 0.5 x A x^T with kappa(A) = 1e3: the Gram of gradient
    samples x_i A is ~A^2, so the inverse root turns x A into ~x (the
    Newton direction), while plain GD is capped at lr <= 2/lambda_max."""
    rng = _rng(2)
    q, _ = np.linalg.qr(rng.normal(size=(32, 32)))
    a = torch.from_numpy(((q * np.logspace(0, 3, 32)) @ q.T)
                         .astype(np.float32))
    pre = BlockAMCPrecond(damping=1e-3, leaf_size=8, max_dim=64, beta=0.0)
    samples = torch.from_numpy(rng.normal(size=(256, 32))
                               .astype(np.float32)) @ a
    state = pre.refresh_inverses(
        pre.update_stats({"x": samples}, pre.init({"x": samples})))

    def run(precond: bool, steps=60):
        x = torch.ones((1, 32))
        lr = 0.3 if precond else 1e-3    # GD capped by 2/lambda_max = 2e-3
        for _ in range(steps):
            g = x @ a
            if precond:
                g = pre.precondition({"x": g}, state)["x"]
            x = x - lr * g
        return float(0.5 * (x @ a @ x.T)[0, 0])

    assert run(True) < 0.1 * run(False)


def test_analog_refresh_programs_one_solver_an_inverse(monkeypatch):
    """use_analog=True: each of the 2 * db_iters inverses programs one
    solver from the key the reference's chain gives it."""
    from repro_torch import keys
    from repro_torch.core import blockamc
    seen = []
    program = blockamc.ProgrammedSolver.program.__func__

    def spy(cls, a, gen, cfg, *args, **kw):
        seen.append(gen.initial_seed())
        return program(cls, a, gen, cfg, *args, **kw)
    monkeypatch.setattr(blockamc.ProgrammedSolver, "program",
                        classmethod(spy))
    pre = BlockAMCPrecond(damping=5e-2, max_dim=64, use_analog=True,
                          db_iters=3)
    g = torch.from_numpy(_grads(1, (16, 8)))
    pre.refresh_inverses(pre.update_stats({"w": g}, pre.init({"w": g})),
                         key=keys.PRNGKey(5))
    want = []
    for i in range(3):
        ki = keys.fold_in(keys.PRNGKey(5), i)
        for k in (ki, keys.fold_in(ki, 1)):
            want.append(keys.generator(k).initial_seed())
    assert seen == want
