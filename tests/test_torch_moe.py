"""The port's MoE FFN (`repro_torch.models.moe`) and the MoE architectures
(phi3.5-moe, llama4-maverick) against the JAX package, on a CPU host, at
`reduce_cfg` size (float32: d_model 64, d_ff 128, 4 experts).

The JAX package draws the weights; `repro_torch.interop` carries them
across; inputs are made with numpy from a seed and fed to both.

Tolerances:
  * `capacity`, `effective_groups`, the dropped-slot count and the
    routing: equal exactly (integer arithmetic; the float32 router's
    choices are far from ties on these inputs);
  * `moe_ffn` outputs and aux loss: 2e-5 absolute on top of 2e-4
    relative, `test_moe_properties.py`'s tolerance (float32 expert GEMMs
    summed in another order);
  * its gradients: 1e-4 of max|g| per leaf;
  * outputs across group counts without drops: 1e-5 relative, 1e-6
    absolute, as the reference's invariance test;
  * whole models: `_torch_lm_parity`'s (2e-4; gradients 1e-4 of max|g|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro.configs import get_config as j_get_config
from repro.models import moe as jmoe
from repro.sharding import api as jshapi
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as tmoe
from repro_torch.sharding import api as tshapi
from repro_torch.sharding import partition as tpart
from tests._hypothesis_compat import given, settings, st
from tests.conftest import reduce_cfg
import _torch_lm_parity as lm

PHI = "phi3.5-moe-42b-a6.6b"
LLAMA4 = "llama4-maverick-400b-a17b"


def _cfgs(arch=PHI, **kw):
    jcfg = dataclasses.replace(reduce_cfg(j_get_config(arch)), **kw)
    return jcfg, get_config(arch).__class__(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, interop.lm_params_from_numpy(lm.np_tree(jp), device="cpu")


def _x(shape, seed=1, positive=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return np.abs(x) * 0.3 + 0.1 if positive else x * 0.5


def _moe_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=2e-4, atol=2e-5)


def _dropped_np(params, x, cfg, g=1):
    """Dropped slots counted from the router alone, in numpy."""
    xf = x.reshape(-1, cfg.d_model).astype(np.float64)
    logits = xf @ np.asarray(params["router"], np.float64)
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
    cap = jmoe.capacity(xf.shape[0] // g, cfg)
    counts = np.stack([np.bincount(grp.ravel(), minlength=cfg.n_experts)
                       for grp in top.reshape(g, -1, cfg.top_k)])
    return int(np.clip(counts - cap, 0, None).sum())


@settings(max_examples=40, deadline=None)
@given(t=st.integers(1, 4096), k=st.integers(1, 4), e=st.integers(2, 128),
       cf=st.floats(1.0, 4.0))
def test_capacity_equals_the_reference(t, k, e, cf):
    jcfg, tcfg = _cfgs(top_k=k, n_experts=e, capacity_factor=cf)
    c = tmoe.capacity(t, tcfg)
    assert c == jmoe.capacity(t, jcfg)
    assert c >= 1 and c * e >= min(t * k, e)
    if c >= 8:
        assert c % 8 == 0


@settings(max_examples=40, deadline=None)
@given(t=st.integers(1, 4096), g=st.sampled_from([1, 2, 4, 8, 16, 32]))
def test_effective_groups_equals_the_reference(t, g):
    eg = tmoe.effective_groups(t, g)
    assert eg == jmoe.effective_groups(t, g)
    assert eg >= 1 and g % eg == 0
    if eg > 1:
        assert t % eg == 0 and t // eg >= 64


@pytest.mark.parametrize("case", ["no_drops", "drops"])
def test_moe_ffn_matches_the_reference(case):
    """Ample capacity (nothing dropped), and the config's 1.25 on positive
    activations, whose routing crowds a few experts (slots dropped, the
    residual passing through)."""
    kw = {"capacity_factor": 8.0} if case == "no_drops" else {}
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _params(jcfg)
    x = _x((2, 32, jcfg.d_model), seed=3, positive=case == "drops")
    want, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    _moe_close(got, want)
    _moe_close(aux, jaux)
    dropped = tmoe.dropped_slots(torch.from_numpy(x), tp, tcfg)
    assert dropped == _dropped_np(jp, x, jcfg)
    assert (dropped == 0) == (case == "no_drops")


def test_moe_ffn_gradient_matches_the_reference():
    """d/d(x, router, experts) of sum(w * out) + aux, with drops."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((2, 32, jcfg.d_model), seed=4, positive=True)
    w = _x((2, 32, jcfg.d_model), seed=5)
    assert tmoe.dropped_slots(torch.from_numpy(x), tp, tcfg) > 0

    def jloss(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, jcfg)
        return jnp.sum(out * w) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_ffn(leaves, tx, tcfg)
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    lm.grads_close({k: v.grad for k, v in leaves.items()}, lm.np_tree(jgp))
    lm.grads_close({"x": tx.grad}, {"x": np.asarray(jgx)})


def test_shared_expert_matches_the_reference():
    """llama4-maverick's layout: top-1 routing plus the shared expert."""
    jcfg, tcfg = _cfgs(LLAMA4)
    assert jcfg.shared_expert and jcfg.top_k == 1
    jp, tp = _params(jcfg, seed=2)
    assert sorted(tp["shared"]) == ["down", "gate", "up"]
    x = _x((2, 16, jcfg.d_model), seed=6)
    want, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    _moe_close(got, want)
    _moe_close(aux, jaux)


def test_dp_groups_hint_matches_the_reference_and_changes_nothing():
    """The policy's `dp_groups` hint splits dispatch into groups: with
    ample capacity the output is the same at every group count (the
    reference's invariance test), and at g=2 it equals the reference's."""
    jcfg, tcfg = _cfgs(capacity_factor=16.0)
    jp, tp = _params(jcfg)
    x = _x((4, 64, jcfg.d_model), seed=7)
    outs = []
    for g in (1, 2, 4):
        with tshapi.policy_scope(tshapi.ShardingPolicy(
                None, {}, meta={"dp_groups": g})):
            assert tshapi.get_meta("dp_groups") == g
            outs.append(tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)[0])
    assert tshapi.current_policy() is None
    for out in outs[1:]:
        np.testing.assert_allclose(out.numpy(), outs[0].numpy(),
                                   rtol=1e-5, atol=1e-6)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    with jshapi.policy_scope(jshapi.ShardingPolicy(
            mesh, {}, meta={"dp_groups": 2})):
        want, _ = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    _moe_close(outs[1], want)


def test_shard_is_the_identity_without_a_policy():
    x = torch.ones(3)
    assert tshapi.shard(x, "act_gecd") is x
    assert tshapi.get_meta("dp_groups", 5) == 5
    assert not dist.is_initialized()
    try:        # a name the policy binds lays x out on its mesh
        mesh = make_host_mesh(device="cpu")
        with tshapi.policy_scope(tshapi.ShardingPolicy(
                mesh, {"other": tpart.P("data")})):
            assert tshapi.shard(x, "act_gecd") is x
            out = tshapi.shard(x, "other")
            assert tshapi.is_dtensor(out)
            assert torch.equal(out.full_tensor(), x)
            assert tshapi.shard(out, "other") is out    # already laid out
    finally:
        dist.destroy_process_group()


def test_aux_loss_balanced_vs_collapsed():
    """The Switch aux loss is ~1 for spread routing and ~E when every
    token routes to one expert, equal to the reference's in both."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((2, 32, jcfg.d_model), seed=8, positive=True)
    _, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    _, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    collapsed = dict(tp, router=torch.zeros_like(tp["router"]))
    collapsed["router"][:, 0] = 1.0
    _, aux_c = tmoe.moe_ffn(collapsed, torch.from_numpy(x), tcfg)
    jcol = dict(jp, router=jnp.zeros_like(jp["router"]).at[:, 0].set(1.0))
    _, jaux_c = jmoe.moe_ffn(jcol, jnp.asarray(x), jcfg)
    _moe_close(aux, jaux)
    _moe_close(aux_c, jaux_c)
    assert float(aux_c) > 2.0 * float(aux)
    assert float(aux_c) == pytest.approx(tcfg.n_experts, rel=0.1)


@pytest.mark.parametrize("check", ["init_layout", "forward", "train_step",
                                   "prefill_then_decode",
                                   "decode_from_zero_cache"])
@pytest.mark.parametrize("arch", [PHI, LLAMA4])
def test_moe_architecture_matches_the_reference(arch, check):
    getattr(lm, f"check_{check}")(arch)
