"""The port's training path (`repro_torch.data.pipeline`,
`repro_torch.train`, `launch/train.py`, the transformer's `remat`)
against the JAX package, on a CPU host, at
`reduce_cfg(get_config("glm4-9b"))` (float32: 4 layers, d_model 64, 4
heads, 2 KV heads, head_dim 16, vocab 512), sequences of 32.

Random weights cannot be replayed across frameworks, so the JAX package
draws them and `repro_torch.interop` carries the parameters and the
optimizer state across; the data pipeline draws the same numpy streams in
both packages, bit for bit.

Tolerances:
  * data: equal;
  * loss: 1e-5 relative; gradients: 1e-4 of max|g| per leaf (float32
    sums in another order through softmax, four layers and the
    backward);
  * a step's updated parameters: 1e-5 absolute on top of 1e-4 relative -
    a first Adam update is ~lr * sign(g), and an element whose gradient
    is within rounding of zero may move by up to lr * lr_scale
    (5e-6 at step 0) in one package and not the other;
  * three steps' losses: 1e-4 relative;
  * a resumed run's next loss against the run that wrote the checkpoint:
    1e-4 relative across packages, equal within the port.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.configs.base import RunConfig as JRunConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import transformer as jtr
from repro.optim.adamw import AdamW as JAdamW
from repro.train import train_step as jts
from repro.train.trainer import Trainer as JTrainer
from repro_torch import interop
from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as ttr
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding import partition as tpart
from repro_torch.sharding.api import policy_scope
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer
from repro_torch.tree import tree_leaves, tree_map
from tests.conftest import reduce_cfg

RUN = dict(mode="train", seq_len=32, global_batch=4, remat="dots")


def _cfgs(arch="glm4-9b"):
    jcfg = reduce_cfg(j_get_config(arch))
    return jcfg, get_config(arch).__class__(**dataclasses.asdict(jcfg))


def _runs(jcfg, tcfg, **kw):
    run = dict(RUN, **kw)
    return JRunConfig(model=jcfg, **run), RunConfig(model=tcfg, **run)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pairs(got, want, prefix=""):
    assert sorted(got) == sorted(want), prefix
    for key in sorted(want):
        if isinstance(want[key], dict):
            yield from _pairs(got[key], want[key], f"{prefix}/{key}")
        else:
            yield f"{prefix}/{key}", got[key], want[key]


def _grads_close(got, want, rel=1e-4):
    for key, g, w in _pairs(got, want):
        w = np.asarray(w, np.float32)
        bound = rel * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= bound, f"{key}: max abs err {err:.3g} > {bound:.3g}"


def _params_close(got, want):
    for key, g, w in _pairs(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=1e-4,
                                   atol=1e-5, err_msg=key)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams


# ------------------------------- data -------------------------------------

@pytest.mark.parametrize("arch", ["glm4-9b", "pixtral-12b"],
                         ids=["tokens", "vit_stub"])
def test_synthetic_batches_equal_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jrun, trun = _runs(jcfg, tcfg, global_batch=6)
    for step, shards in ((0, (1, 0)), (5, (1, 0)), (3, (2, 1))):
        want = JSyntheticLM(jcfg, jrun, seed=7, n_shards=shards[0],
                            shard=shards[1]).batch(step)
        got = SyntheticLM(tcfg, trun, seed=7, n_shards=shards[0],
                          shard=shards[1], device="cpu").batch(step)
        assert sorted(got) == sorted(want)
        for key in want:
            if key != "embeds":
                assert got[key].dtype == torch.int64
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def test_data_pipeline_determinism():
    _, tcfg = _cfgs()
    run = RunConfig(model=tcfg, **RUN)
    d1 = SyntheticLM(tcfg, run, seed=5, device="cpu").batch(3)
    d2 = SyntheticLM(tcfg, run, seed=5, device="cpu").batch(3)
    assert torch.equal(d1["tokens"], d2["tokens"])
    d3 = SyntheticLM(tcfg, run, seed=5, device="cpu").batch(4)
    assert not torch.equal(d1["tokens"], d3["tokens"])


def test_labels_are_next_tokens():
    _, tcfg = _cfgs()
    b = SyntheticLM(tcfg, RunConfig(model=tcfg, **RUN), seed=1,
                    device="cpu").batch(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pipeline_defaults_to_the_card():
    _, tcfg = _cfgs()
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        SyntheticLM(tcfg, RunConfig(model=tcfg, **RUN))


# ----------------------------- loss and grads ------------------------------

@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_loss_and_gradients_match_the_reference(model, remat):
    jcfg, tcfg, jparams = model
    jrun, trun = _runs(jcfg, tcfg, remat=remat)
    jbatch = JSyntheticLM(jcfg, jrun, seed=3).batch(0)
    jbatch = dict(jbatch, labels=jbatch["labels"].at[0, :5].set(-1))
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p, b: jts.loss_fn(p, b, jcfg, remat), has_aux=True)(
            jparams, jbatch)
    tparams = interop.lm_params_from_numpy(_np(jparams), device="cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    loss, met, grads = tts.value_and_grad(tparams, tbatch, tcfg, remat)
    assert not any(p.requires_grad for p in tree_leaves(tparams))
    assert _rel(loss, jloss) <= 1e-5
    assert _rel(met["ce"], jmet["ce"]) <= 1e-5
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    _grads_close(grads, jgrads)


def test_remat_changes_memory_never_values(model):
    """The three remat modes give the port the same loss and gradients:
    1e-6 of max|g| per leaf (the recomputation repeats the same float32
    operations, on buffers at other addresses, which a BLAS may sum in
    another order)."""
    jcfg, tcfg, jparams = model
    tparams = interop.lm_params_from_numpy(_np(jparams), device="cpu")
    _, trun = _runs(jcfg, tcfg)
    batch = SyntheticLM(tcfg, trun, seed=2, device="cpu").batch(0)
    outs = {r: tts.value_and_grad(tparams, batch, tcfg, r)
            for r in ("none", "dots", "full")}
    for r in ("dots", "full"):
        assert _rel(outs[r][0], outs["none"][0]) <= 1e-6
        _grads_close(outs[r][2], outs["none"][2], rel=1e-6)


def _count_backward_ops(tparams, tcfg, batch, remat):
    """Matmul and batched-matmul calls during the backward of one
    loss (a dispatch-level count)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    counts = {"mm": 0, "bmm": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in ("mm", "addmm"):
                counts["mm"] += 1
            elif name in ("bmm", "baddbmm"):
                counts["bmm"] += 1
            return func(*args, **(kwargs or {}))

    diff = tree_map(lambda p: p.detach().requires_grad_(), tparams)
    leaves = list(tree_leaves(diff))
    loss, _ = tts.loss_fn(diff, batch, tcfg, remat)
    with Count():
        torch.autograd.grad(loss, leaves)
    return counts


def test_dots_remat_saves_the_projections_and_recomputes_attention(model):
    """Under "dots" the backward recomputes the attention's batched score
    products (more bmm calls than "none") but no projection (the same mm
    count); under "full" it recomputes the projections too."""
    jcfg, tcfg, jparams = model
    tparams = interop.lm_params_from_numpy(_np(jparams), device="cpu")
    _, trun = _runs(jcfg, tcfg)
    batch = SyntheticLM(tcfg, trun, seed=2, device="cpu").batch(0)
    c = {r: _count_backward_ops(tparams, tcfg, batch, r)
         for r in ("none", "dots", "full")}
    per_layer_bmm = 2                       # scores and p . v, one chunk
    assert c["dots"]["mm"] == c["none"]["mm"]
    assert c["dots"]["bmm"] == c["none"]["bmm"] + per_layer_bmm * 4
    assert c["full"]["mm"] > c["none"]["mm"]
    assert c["full"]["bmm"] == c["dots"]["bmm"]


# ------------------------------- the step ----------------------------------

def _states(jcfg, tcfg, jrun, lr=1e-3):
    jopt, topt = JAdamW(lr=lr), AdamW(lr=lr)
    jstate, _ = jts.init_train_state(jax.random.PRNGKey(0), jcfg, jrun, jopt)
    npstate = _np(jstate)
    tstate = interop.train_state_from_numpy(npstate.params, npstate.opt,
                                            device="cpu")
    return jopt, topt, jstate, tstate


@pytest.mark.parametrize("microbatch", [None, 1], ids=["one", "four_micro"])
def test_train_step_matches_the_reference(model, microbatch):
    jcfg, tcfg, _ = model
    jrun, trun = _runs(jcfg, tcfg, microbatch=microbatch)
    jopt, topt, jstate, tstate = _states(jcfg, tcfg, jrun)
    jbatch = JSyntheticLM(jcfg, jrun, seed=3).batch(0)
    tbatch = SyntheticLM(tcfg, trun, seed=3, device="cpu").batch(0)
    js, jm = jax.jit(jts.make_train_step(jcfg, jrun, jopt))(jstate, jbatch)
    ts, tm = tts.make_train_step(tcfg, trun, topt)(tstate, tbatch)
    assert sorted(tm) == sorted(jm)
    for key in ("loss", "ce", "grad_norm"):
        assert _rel(tm[key], jm[key]) <= 1e-5, key
    assert float(tm["lr_scale"]) == float(jm["lr_scale"])
    assert int(ts.opt.step) == int(js.opt.step) == 1
    _params_close(ts.params, js.params)
    _params_close(ts.opt.m, js.opt.m)


def test_three_steps_losses_match_the_reference(model):
    jcfg, tcfg, _ = model
    jrun, trun = _runs(jcfg, tcfg)
    jopt, topt, jstate, tstate = _states(jcfg, tcfg, jrun, lr=3e-3)
    jstep = jax.jit(jts.make_train_step(jcfg, jrun, jopt))
    tstep = tts.make_train_step(tcfg, trun, topt)
    jdata = JSyntheticLM(jcfg, jrun, seed=4)
    tdata = SyntheticLM(tcfg, trun, seed=4, device="cpu")
    for i in range(3):
        jstate, jm = jstep(jstate, jdata.batch(i))
        tstate, tm = tstep(tstate, tdata.batch(i))
        assert _rel(tm["loss"], jm["loss"]) <= 1e-4, i


def test_grad_shardings_other_than_none_raise(model):
    """grad_shardings must be `NamedSharding`s; on a one-rank mesh a step
    that lays every gradient out as its parameter is the plain step."""
    jcfg, tcfg, _ = model
    jrun, trun = _runs(jcfg, tcfg, microbatch=1)
    with pytest.raises(TypeError, match="NamedSharding"):
        tts.make_train_step(tcfg, trun, AdamW(), grad_shardings={"w": 0})
    _, topt, _, tstate = _states(jcfg, tcfg, jrun)
    batch = SyntheticLM(tcfg, trun, seed=3, device="cpu").batch(0)
    want, wm = tts.make_train_step(tcfg, trun, topt)(tstate, batch)
    assert not dist.is_initialized()
    try:
        mesh = make_host_mesh(device="cpu")
        with policy_scope(tpart.make_policy(mesh, tcfg, trun)):
            placed = tpart.distribute(tstate, tpart.make_state_shardings(
                tstate, mesh, trun.fsdp))
            gsh = tpart.make_param_shardings(tstate.params, mesh, trun.fsdp)
            got, gm = tts.make_train_step(tcfg, trun, topt,
                                          grad_shardings=gsh)(placed, batch)
    finally:
        dist.destroy_process_group()
    assert float(gm["loss"]) == float(wm["loss"])
    assert all(type(v) is torch.Tensor for v in gm.values())
    for key, g, w in _pairs(got.params, want.params):
        assert torch.equal(g.full_tensor(), w), key


# ------------------------------ the trainer --------------------------------

def _trainer(tcfg, **kw):
    run = RunConfig(model=tcfg, **RUN)
    return Trainer(tcfg, run, log_every=1000, device="cpu", **kw)


def test_loss_decreases():
    _, tcfg = _cfgs()
    hist = _trainer(tcfg, seed=0).run(30)
    first5, last5 = np.mean(hist["loss"][:5]), np.mean(hist["loss"][-5:])
    assert last5 < first5 - 0.1, (first5, last5)


def test_checkpoint_roundtrip(tmp_path):
    _, tcfg = _cfgs()
    state, _ = tts.init_train_state(torch.Generator().manual_seed(0), tcfg,
                                    RunConfig(model=tcfg, **RUN),
                                    AdamW(lr=1e-3))
    save_checkpoint(str(tmp_path), 7, state)
    assert latest_step(str(tmp_path)) == 7
    restored = restore_checkpoint(str(tmp_path), 7, state)
    assert type(restored) is type(state)
    for a, b in zip(tree_leaves(state.params), tree_leaves(restored.params)):
        assert torch.equal(a, b)
    assert torch.equal(state.opt.step, restored.opt.step)


def test_bfloat16_state_checkpoint_roundtrip(tmp_path):
    _, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    state, _ = tts.init_train_state(torch.Generator().manual_seed(0), tcfg,
                                    RunConfig(model=tcfg, **RUN),
                                    AdamW(moments_dtype=torch.bfloat16))
    save_checkpoint(str(tmp_path), 1, state)
    restored = restore_checkpoint(str(tmp_path), 1, state)
    for a, b in zip(tree_leaves(state.params), tree_leaves(restored.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomicity(tmp_path):
    _, tcfg = _cfgs()
    state, _ = tts.init_train_state(torch.Generator().manual_seed(0), tcfg,
                                    RunConfig(model=tcfg, **RUN))
    save_checkpoint(str(tmp_path), 1, state)
    os.makedirs(str(tmp_path / "step_00000002.tmp"))
    assert latest_step(str(tmp_path)) == 1


def test_checkpoint_manager_async(tmp_path):
    _, tcfg = _cfgs()
    state, _ = tts.init_train_state(torch.Generator().manual_seed(0), tcfg,
                                    RunConfig(model=tcfg, **RUN))
    mgr = CheckpointManager(str(tmp_path), every=2, keep=2)
    for step in range(1, 9):
        mgr.maybe_save(step, state)
    mgr.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(str(tmp_path))
                   if n.startswith("step_"))
    assert steps == [6, 8]


def test_trainer_resume(tmp_path):
    """Stop after 4 steps; a new Trainer resumes from the checkpoint and
    its next steps reproduce the uninterrupted run's losses."""
    _, tcfg = _cfgs()
    t1 = _trainer(tcfg, ckpt_dir=str(tmp_path), ckpt_every=2)
    t1.run(4)
    assert latest_step(str(tmp_path)) == 4
    t2 = _trainer(tcfg, ckpt_dir=str(tmp_path), ckpt_every=2)
    assert t2.start_step == 4
    for a, b in zip(tree_leaves(t1.state.params),
                    tree_leaves(t2.state.params)):
        assert torch.equal(a, b)
    hist = t2.run(2)
    assert hist["step"] == [4, 5]
    whole = _trainer(tcfg).run(6)
    assert hist["loss"] == whole["loss"][4:]


def test_port_trainer_resumes_a_jax_trainer_checkpoint(tmp_path):
    """The reference's Trainer writes a checkpoint at step 2; the port's
    Trainer restores it (same leaf keys) and its next loss is the
    reference's own next loss."""
    jcfg, tcfg = _cfgs()
    jrun, trun = _runs(jcfg, tcfg)
    jt = JTrainer(jcfg, jrun, ckpt_dir=str(tmp_path), ckpt_every=2,
                  log_every=1000)
    jhist = jt.run(3)
    assert latest_step(str(tmp_path)) == 2
    tt = Trainer(tcfg, trun, ckpt_dir=str(tmp_path), ckpt_every=100,
                 log_every=1000, device="cpu")
    assert tt.start_step == 2 and int(tt.state.opt.step) == 2
    thist = tt.run(1)
    assert thist["step"] == [2]
    assert _rel(thist["loss"][0], jhist["loss"][2]) <= 1e-4


def test_launcher_trains_on_the_host():
    from repro_torch.launch import train
    hist = train.main(["--arch", "glm4-9b", "--host-scale", "--steps", "2",
                       "--device", "cpu"])
    assert hist["step"] == [0, 1]
    assert all(np.isfinite(hist["loss"]))
