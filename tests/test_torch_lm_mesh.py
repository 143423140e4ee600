"""The language model's mesh in the port (`sharding/partition.py`'s rules,
`launch/mesh.py`'s host and production meshes, `sharding.api.shard` under
a policy, `grad_shardings`, the sharded save and `sharding_tree` restore,
`ElasticMesh.make_mesh`, `compressed_psum`) against the JAX package.

- Specs: every parameter and state leaf of five architectures at their
  published sizes (shapes only), on four meshes, with FSDP on and off,
  equal to the reference's `param_spec` / `make_state_shardings` exactly;
  the reference runs on a `jax.sharding.AbstractMesh` (no devices), the
  port on a `DeviceMesh` under a "fake" process group (no ranks).  The
  same cases hold `activation_rules`, `dp_group_count` and the spec to
  placement map (each leaf's shard shape against JAX's).
- Real splits: gloo ranks in subprocesses over a `FileStore`
  (`tests/_torch_mesh_ranks.py`), each world started once per module; a
  fixture reads each check's numbers, so each check is its own test.  The
  JAX side (weights, single-device losses, the int8 quantiser) runs here.
  Tolerances: the loss against JAX's single-device loss rtol 1e-4 (the
  reference's own, `tests/test_dryrun_sharding.py:84`); the sharded step
  against the port's unsharded step 1e-5 of max|p| over the state (one
  Adam step moves each element by about lr x warmup, so a leaf that
  starts at zero - the norms - holds only that step, whose float32
  rounding is no measure of the leaf); logits 1e-5 of max|logit|.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding

from repro.configs import get_config as j_get_config
from repro.configs.base import RunConfig as JRunConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import grad_compression as jgc
from repro.optim.adamw import AdamW as JAdamW
from repro.sharding import partition as jpart
from repro.train import train_step as jts
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.optim.adamw import OptState
from repro_torch.sharding import partition as tpart
from repro_torch.train.train_step import TrainState

import _torch_mesh_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARCHS = ["glm4-9b", "stablelm-1.6b", "phi3.5-moe-42b-a6.6b", "mamba2-130m",
         "recurrentgemma-2b"]
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture
def fake_world():
    """A "fake" process group of `size` ranks in this process (no
    communication), destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    started = []

    def start(size):
        assert not dist.is_initialized()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)
        started.append(size)
    yield start
    if started:
        dist.destroy_process_group()


# ------------------------------- the specs ---------------------------------

def _runs(arch, fsdp):
    """Run configs that take each branch of `activation_rules`: the
    batch over every batch axis, Megatron-SP, a batch that divides "data"
    only, and one that divides nothing."""
    cfg = get_config(arch)
    return [RunConfig(model=cfg, mode="train", seq_len=4096,
                      global_batch=256, fsdp=fsdp),
            RunConfig(model=cfg, mode="train", seq_len=4096,
                      global_batch=256, fsdp=fsdp, seq_shard=True),
            RunConfig(model=cfg, mode="decode", seq_len=4096,
                      global_batch=6, fsdp=fsdp),
            RunConfig(model=cfg, mode="prefill", seq_len=1024,
                      global_batch=1, fsdp=fsdp)]


def _meta(tree):
    """The port's TrainState of meta tensors shaped as JAX's."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.empty(node.shape, device="meta")
    return TrainState(params=walk(tree.params),
                      opt=OptState(step=walk(tree.opt.step),
                                   m=walk(tree.opt.m), v=walk(tree.opt.v)))


def _jax_specs(tree):
    return {jax.tree_util.keystr(path): sh.spec for path, sh in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(fake_world, arch, mesh_name, fsdp):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, names = MESHES[mesh_name]
    fake_world(int(np.prod(shape)))
    tmesh_ = torch.distributed.device_mesh.init_device_mesh(
        "cpu", shape, mesh_dim_names=names)
    jmesh = AbstractMesh(shape, names)
    jcfg = j_get_config(arch)
    jrun = JRunConfig(model=jcfg, mode="train", seq_len=4096,
                      global_batch=256, fsdp=fsdp)
    jstate = jax.eval_shape(lambda: jts.init_train_state(
        jax.random.PRNGKey(0), jcfg, jrun, JAdamW())[0])
    state = _meta(jstate)

    want = _jax_specs(jpart.make_state_shardings(jstate, jmesh, fsdp))
    got = {key: sh.spec for key, sh in flatten(
        tpart.make_state_shardings(state, tmesh_, fsdp))}
    assert list(got) == list(want)
    shapes = {key: tuple(x.shape) for key, x in flatten(state)}
    for key, spec in want.items():
        assert tuple(got[key]) == tuple(spec), key
        # the placements cut each leaf as JAX's sharding does
        local, _ = compute_local_shape_and_global_offset(
            shapes[key], tmesh_, tpart.placements(got[key], tmesh_))
        assert tuple(local) == tuple(JNamedSharding(jmesh, spec)
                                     .shard_shape(shapes[key])), key

    want_p = _jax_specs(jpart.make_param_shardings(jstate.params, jmesh,
                                                   fsdp))
    got_p = {key: sh.spec for key, sh in flatten(
        tpart.make_param_shardings(state.params, tmesh_, fsdp))}
    assert list(got_p) == list(want_p)
    assert all(tuple(got_p[k]) == tuple(s) for k, s in want_p.items())

    for run in _runs(arch, fsdp):
        jr = JRunConfig(model=jcfg, mode=run.mode, seq_len=run.seq_len,
                        global_batch=run.global_batch, fsdp=run.fsdp,
                        seq_shard=run.seq_shard)
        rules = tpart.activation_rules(tmesh_, run.model, run)
        jrules = jpart.activation_rules(jmesh, jcfg, jr)
        assert sorted(rules) == sorted(jrules)
        assert all(tuple(rules[k]) == tuple(v) for k, v in jrules.items())
        assert tpart.dp_group_count(tmesh_, run.model, run) == \
            jpart.dp_group_count(jmesh, jcfg, jr)
        assert tuple(tpart.batch_sharding(tmesh_, run.model, run).spec) == \
            tuple(jpart.batch_sharding(jmesh, jcfg, jr).spec)
        policy = tpart.make_policy(tmesh_, run.model, run)
        assert policy.mesh is tmesh_ and policy.rules == rules
        assert policy.meta == {"dp_groups": tpart.dp_group_count(
            tmesh_, run.model, run)}


def test_placements_name_each_mesh_dim(fake_world):
    from torch.distributed.tensor import Replicate, Shard
    fake_world(8)
    m = torch.distributed.device_mesh.init_device_mesh(
        "cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    P = tpart.P
    assert tpart.placements(P(("pod", "data"), None, "model"), m) == \
        [Shard(0), Shard(0), Shard(2)]
    assert tpart.placements(P(None, "data"), m) == \
        [Replicate(), Shard(1), Replicate()]
    assert tpart.placements(P(), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        tpart.placements(P(("data", "pod")), m)
    with pytest.raises(ValueError, match="twice"):
        tpart.placements(P("data", "data"), m)
    assert repr(P("data", None)) == "PartitionSpec('data', None)"


def test_production_mesh_has_the_reference_shape_and_names(fake_world):
    fake_world(256)
    m = tmesh.make_production_mesh(device="cpu")
    assert tuple(m.shape) == (16, 16)
    assert m.mesh_dim_names == ("data", "model")
    with pytest.raises(ValueError, match="world has 256"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="world has 256"):
        tmesh.make_host_mesh(4, 2, device="cpu")


def test_multi_pod_production_mesh(fake_world):
    fake_world(512)
    m = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert tuple(m.shape) == (2, 16, 16)
    assert m.mesh_dim_names == ("pod", "data", "model")


def test_production_mesh_raises_on_a_world_of_one():
    assert not dist.is_initialized()
    try:
        with pytest.raises(ValueError, match="256 ranks, the world has 1"):
            tmesh.make_production_mesh(device="cpu")
        assert tuple(tmesh.make_host_mesh(device="cpu").shape) == (1, 1)
    finally:
        dist.destroy_process_group()


# ---------------------------- gloo ranks ----------------------------------

def _flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(p.key) for p in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf)
    return out


def _jax_run(fields, arch, **kw):
    jcfg = dataclasses.replace(j_get_config(arch), **fields)
    return jcfg, JRunConfig(model=jcfg, mode="train", seq_len=32,
                            global_batch=8, **kw)


def _jax_state(name, fields, arch):
    jcfg, jrun = _jax_run(fields, arch)
    state, _ = jts.init_train_state(jax.random.PRNGKey(0), jcfg, jrun,
                                    JAdamW(lr=1e-3))
    out = _flat(state.params, f"{name}/params")
    out.update(_flat(state.opt.m, f"{name}/m"))
    out.update(_flat(state.opt.v, f"{name}/v"))
    out[f"{name}/step"] = np.asarray(state.opt.step)
    return out, state


def _jax_loss(state, fields, arch, pad=False, **kw):
    jcfg, jrun = _jax_run(fields, arch, remat="dots", fsdp=True, **kw)
    opt = JAdamW(lr=1e-3)
    batch = JSyntheticLM(jcfg, jrun, seed=1).batch(0)
    if pad:
        batch = dict(batch, labels=jnp.asarray(
            ranks.pad_labels(np.array(batch["labels"]))))
    _, m = jax.jit(jts.make_train_step(jcfg, jrun, opt))(state, batch)
    return float(m["loss"])


def _start(world, work, n):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    # ranks run niced: a world is up to eight busy processes, and the
    # other test workers' timed waits come first
    return [subprocess.Popen(
        ["nice", "-n", "10", sys.executable,
         os.path.join(REPO, "tests", "_torch_mesh_ranks.py"),
         world, str(work / "store"), str(work)], env=dict(env, RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]


def _wait(procs, timeout=300):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-4000:]}"


class _World:
    def __init__(self, work, jax_side):
        self.work, self.jax = work, jax_side

    def check(self, name):
        errs = sorted(self.work.glob(f"{name}.rank*.json"))
        for path in [self.work / f"{name}.json"] + errs:
            with open(path) as f:
                out = json.load(f)
            assert "error" not in out, f"{path.name}:\n{out['error']}"
        with open(self.work / f"{name}.json") as f:
            return json.load(f)


@pytest.fixture(scope="module")
def lm_world(tmp_path_factory):
    """Eight gloo ranks on a (4, 2) ("data", "model") mesh: the sharded
    train steps, the context-parallel rule, the MoE forward, prefill and
    decode."""
    work = tmp_path_factory.mktemp("lm_world")
    inputs, states = {}, {}
    for name, fields, arch in (("dense", ranks.DENSE, "glm4-9b"),
                               ("context", ranks.CONTEXT, "glm4-9b"),
                               ("moe", ranks.MOE, "phi3.5-moe-42b-a6.6b")):
        flat, states[name] = _jax_state(name, fields, arch)
        inputs.update(flat)
    np.savez(work / "in.npz", **inputs)
    procs = _start("lm", work, 8)
    try:        # JAX's single-device steps while the ranks run
        jax_side = {
            "dense": _jax_loss(states["dense"], ranks.DENSE, "glm4-9b"),
            "dense_micro": _jax_loss(states["dense"], ranks.DENSE,
                                     "glm4-9b", microbatch=4),
            "dense_seq": _jax_loss(states["dense"], ranks.DENSE, "glm4-9b",
                                   pad=True, microbatch=4, seq_shard=True),
            "context": _jax_loss(states["context"], ranks.CONTEXT,
                                 "glm4-9b")}
    finally:
        _wait(procs)
    return _World(work, jax_side)


@pytest.fixture(scope="module")
def elastic_world(tmp_path_factory):
    """Four gloo ranks: a sharded save on (2, 2) restored onto the
    elastic (1, 4) mesh, `compressed_psum` over a (2, 2) ("pod",
    "data") mesh, and `CheckpointManager` on a sharded state."""
    work = tmp_path_factory.mktemp("elastic_world")
    inputs, _ = _jax_state("dense", ranks.DENSE, "glm4-9b")
    g = np.random.default_rng(0).normal(size=(2, 256)).astype(np.float32)
    inputs["psum/g"] = g
    np.savez(work / "in.npz", **inputs)
    _wait(_start("elastic", work, 4))
    return _World(work, {"g": g})


def _step_close(out, jax_loss):
    assert out["metric_types"] == ["Tensor"]
    assert abs(out["loss"] - jax_loss) <= 1e-4 * abs(jax_loss)
    assert abs(out["loss"] - out["plain_loss"]) <= 1e-6 * abs(jax_loss)
    assert abs(out["grad_norm"] - out["plain_grad_norm"]) <= \
        1e-5 * out["plain_grad_norm"]
    assert out["param_err"] <= 1e-5 * out["param_scale"], out
    assert out["m_err"] <= 1e-5 * out["m_scale"], out


@pytest.mark.parametrize("check,jax_loss", [("train", "dense"),
                                            ("train_micro", "dense_micro")],
                         ids=["one_batch", "microbatches_grad_shardings"])
def test_sharded_train_step_matches_jax_and_the_unsharded_step(
        lm_world, check, jax_loss):
    """The reference's `test_sharded_train_step_executes` on a (4, 2)
    mesh, FSDP, remat "dots"; the state's parameters come back as
    DTensors split over both axes."""
    out = lm_world.check(check)
    _step_close(out, lm_world.jax[jax_loss])
    assert out["placements"] == "(Shard(dim=1), Shard(dim=2))"


def test_sharded_step_with_a_split_sequence_and_padded_microbatches(
        lm_world):
    """Megatron-SP on the (4, 2) mesh (the sequence split over "model"),
    two microbatches whose labels are padded unevenly (48 and 2 pads, so
    a microbatch holding other rows would count another denominator),
    FSDP and grad_shardings: held to JAX's loss and to the unsharded
    step.  Each microbatch reaches the loss with its rows split over
    "data" as the batch's, where slicing it out of the batch would
    gather it whole on every rank (and DTensor's rules raise on fake
    tensors at the split sequence's flatten)."""
    out = lm_world.check("train_seq")
    assert out["act_btd"] == "PartitionSpec('data', 'model', None)"
    # the plain step's two microbatches, then the sharded step's
    assert out["labels_seen"] == ["plain"] * 2 + [
        "(Shard(dim=0), Replicate())"] * 2, out["labels_seen"]
    _step_close(out, lm_world.jax["dense_seq"])


def test_split_rows_lays_microbatches_out_on_each_rank(lm_world):
    """`sharding.api.split_rows` on 4 "data" ranks into 2, 4 and 8 parts:
    the reshape's rows, each part split over "data" (one all-to-all), and
    `take` returns part i laid out as the batch; parts of 2 rows, which 4
    ranks cannot split, come back whole."""
    out = lm_world.check("split_rows")
    for n in (2, 4, 8, 16):
        assert out[f"equal_{n}"] and out[f"take_{n}"], (n, out)
    for n in (2, 4, 8):
        assert out[f"place_{n}"] == "(Shard(dim=1), Replicate())", out
        assert out[f"take_place_{n}"] == "(Shard(dim=0), Replicate())", out
    assert out["place_16"] == "(Replicate(), Replicate())", out


def test_context_parallel_rule_when_heads_do_not_divide(lm_world):
    """Three heads over a model axis of 2: q whole along heads, k and v
    split on the sequence; both attention routes and a step (with
    grad_shardings) equal the unsharded port."""
    out = lm_world.check("context_parallel")
    assert out["act_kv"] == "PartitionSpec('data', 'model', None, None)"
    assert out["act_q"] == "PartitionSpec('data', None, None, None)"
    for route in ("chunked", "flash"):
        assert out[f"{route}_err"] <= 1e-5 * out["logit_scale"], route
    _step_close(out, lm_world.jax["context"])


def test_moe_forward_under_the_policy(lm_world):
    """A 2-layer phi3.5-moe under `make_policy`: four dispatch groups,
    experts split on "model" (act_gecd), against the unsharded forward
    with the same group count."""
    out = lm_world.check("moe")
    assert out["dp_groups"] == 4
    assert out["act_gecd"] == "PartitionSpec('data', 'model', None, None)"
    assert out["err"] <= 1e-5 * out["logit_scale"], out


def test_moe_step_routed_on_each_ranks_rows(lm_world):
    """A 2-layer phi3.5-moe training step under the policy: each of the
    four "data" ranks routes, dispatches and combines its own group's
    rows, the experts split on "model"; loss, aux, gradient norm and the
    state (parameters, Adam m) against the unsharded step with the same
    four groups.  Each rank's expert gradients are its rows' share, summed
    over "data" (DTensor's `to_local` would call them replicated, and
    the stacks' gradient would be one rank's share)."""
    out = lm_world.check("train_moe")
    assert out["dp_groups"] == 4
    assert abs(out["loss"] - out["plain_loss"]) <= 1e-6 * abs(
        out["plain_loss"]), out
    assert abs(out["aux"] - out["plain_aux"]) <= 1e-6 * abs(
        out["plain_aux"]), out
    assert abs(out["grad_norm"] - out["plain_grad_norm"]) <= \
        1e-5 * out["plain_grad_norm"], out
    assert out["param_err"] <= 1e-5 * out["param_scale"], out
    assert out["m_err"] <= 1e-5 * out["m_scale"], out


def test_ssd_step_shares_channels_and_chunks(lm_world):
    """A mamba2-shaped step on the (4, 2) mesh with its SSD's channels
    (a head and a half a rank) and C B^T chunks shared over "model":
    loss and gradient norm 1e-5 relative, parameters and Adam moments
    1e-5 of their max, against the unsharded step."""
    out = lm_world.check("train_ssd")
    assert abs(out["loss"] - out["plain_loss"]) <= 1e-5 * abs(
        out["plain_loss"]), out
    assert abs(out["grad_norm"] - out["plain_grad_norm"]) <= \
        1e-5 * out["plain_grad_norm"], out
    assert out["param_err"] <= 1e-5 * out["param_scale"], out
    assert out["m_err"] <= 1e-5 * out["m_scale"], out


def test_prefill_and_decode_under_the_policy(lm_world):
    """Prefill of 16 tokens and 4 greedy decode steps: the cache split
    on batch ("data") and sequence ("model") and written in place; each
    step's logits and ids against the unsharded run."""
    out = lm_world.check("decode")
    assert out["cache_placements"] == "(Shard(dim=1), Shard(dim=2))"
    assert out["err"] <= 1e-5, out
    assert out["ids_equal"]
    assert out["cache_err"] <= 1e-5


@pytest.mark.parametrize("name", ["dense", "context"])
@pytest.mark.parametrize("case", ["longer", "equal", "ring", "short_ring"])
def test_sharded_prefill_cache_equals_the_unsharded_one(lm_world, name,
                                                        case):
    """`attention_prefill` under the policy on the (4, 2) mesh builds its
    cache on each rank's block of "act_cache" (batch on "data", slots on
    "model"): a rank holds a quarter of the rows and half of the slots,
    never the whole cache, and the cache equals the unsharded call's
    within 1e-6 of its max - a full cache longer than the prompt, one of
    its length, a windowed ring that wraps, one with fewer slots than the
    window; two KV heads split over "model" (exchanged for slots) and
    one whole."""
    out = lm_world.check("prefill_cache")[f"{name}_{case}"]
    b, clen, kv, hd = out["global"]
    assert out["placements"] == "(Shard(dim=0), Shard(dim=1))", out
    assert out["local"] == [b // 4, clen // 2, kv, hd], out
    assert out["err"] <= 1e-6, out


def test_greedy_pick_on_vocab_split_logits(lm_world):
    """`sharding.api.argmax` (the serving steps' greedy pick) on the
    decode check's sharded logits - split over the vocabulary, so each
    rank reduces its own shard - picks the unsharded run's ids at every
    step."""
    out = lm_world.check("decode")
    assert any("Shard(dim=1)" in p for p in out["logits_split"]), out
    assert out["argmax_equal"]


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b",
                                  "llama4-maverick-400b-a17b"])
def test_other_families_under_the_policy(lm_world, arch):
    """The SSD, RG-LRU and interleaved-MoE families (at `reduce_cfg`'s
    size) under the policy on the (4, 2) mesh: forward, prefill and a
    decode step against the unsharded model, 1e-5 of max|logit|."""
    assert lm_world.check("families")[arch] <= 1e-5


@pytest.mark.parametrize("path", ["cp_prefill", "moe_decode", "ssd_decode",
                                  "rglru_prefill"])
def test_repaired_serving_paths_equal_the_unsharded_calls(lm_world, path):
    """The serving paths repaired for the production mesh, on the (4, 2)
    mesh against the unsharded model (the same dispatch groups): logits
    of a prefill and two greedy decode steps, and the caches, within
    1e-5 of their max.  The context-parallel prefill (three heads) takes
    the chunked route with the queries split; the MoE decode routes one
    group over four "data" ranks with slots dropped at capacity - the
    same drops, or a token's output would differ by its expert's - and
    its auxiliary loss; the SSD decode shares the in-projection's 227
    features and the channels over "model"."""
    out = lm_world.check("serving")[path]
    assert out["err"] <= 1e-5, out
    assert out["cache_err"] <= 1e-5, out
    if path == "cp_prefill":
        assert out["flash_calls"] == out["layers"], out  # unsharded only
    if path == "moe_decode":
        assert out["dropped"] > 0 and out["parts_calls"] > 0, out
        assert out["ffn_err"] <= 1e-5, out
        assert out["aux_err"] <= 1e-6 * out["aux"], out
    if path == "ssd_decode":
        assert out["columns_calls"] > 0, out


@pytest.mark.parametrize("prompt", [16, 8])
def test_sharded_ssd_prefill_equals_the_unsharded_one(lm_world, prompt):
    """A 2-layer mamba2-shaped prefill on a (2, 4) mesh, each rank of
    "model" holding z and x on its channel share alone (90 channels, 23
    a rank and a short, padded last share of 21; the gated norm's sum of
    squares summed over the shares): its logits, two greedy decode
    steps' and the cache - the SSD state and the conv history, gathered
    from each rank's last rows (8 tokens leave two a rank, fewer than
    the history's three) - within 1e-6 of their max of the unsharded
    model's."""
    out = lm_world.check("ssd_share")[f"prefill_{prompt}"]
    assert out["err"] <= 1e-6, out
    assert out["cache_err"] <= 1e-6, out


def test_sharded_ssd_step_with_a_short_share_equals_the_unsharded_one(
        lm_world):
    """The same model's differentiated step (FSDP, grad_shardings) on the
    (2, 4) mesh - the gradient through the channel shares, the
    all-to-all that moves them, the norm's summed squares and the padded
    out projection - against the unsharded step: loss and gradient norm
    1e-5 relative, parameters and Adam moments 1e-5 of their max."""
    out = lm_world.check("ssd_share")["step"]
    assert abs(out["loss"] - out["plain_loss"]) <= 1e-5 * abs(
        out["plain_loss"]), out
    assert abs(out["grad_norm"] - out["plain_grad_norm"]) <= \
        1e-5 * out["plain_grad_norm"], out
    assert out["param_err"] <= 1e-5 * out["param_scale"], out
    assert out["m_err"] <= 1e-5 * out["m_scale"], out


def test_context_parallel_prefill_in_small_chunks_equals_the_unsharded_one(
        lm_world):
    """Three heads over the four "model" ranks of a (2, 4) mesh: each rank
    attends its 8 of 32 queries to the whole keys on the chunked route,
    in chunks of 2 queries under a cut score budget (the in-place
    softmax), and the prefill's logits and cache are within 1e-6 of
    their max of the unsharded prefill's."""
    out = lm_world.check("cp_prefill")
    assert out["chunks"] == [2], out
    assert out["err"] <= 1e-6, out
    assert out["cache_err"] <= 1e-6, out


def test_elastic_remesh_restore(elastic_world):
    """The reference's `test_elastic_remesh_restore`: a state saved
    sharded on (2, 2) restores onto `ElasticMesh.make_mesh`'s (1, 4),
    every leaf equal and each rank's shard the right slice."""
    out = elastic_world.check("elastic")
    assert out["choose_shape"] == [1, 4]
    assert out["mesh"] == [1, 4] and out["names"] == ["data", "model"]
    assert out["equal"] and out["slices"] and out["n_leaves"] > 0


def test_checkpoint_manager_writes_a_sharded_tree_from_rank_zero(
        elastic_world):
    """`CheckpointManager` given a DTensor state on 4 ranks: rank 0
    alone writes (and collects the old step), every rank sees the last
    step once `wait` (or a blocking save) returns, and it restores equal
    to the state."""
    ranks = elastic_world.check("manager")["ranks"]
    assert [r["writes"] for r in ranks] == [[1, 2, 3], [], [], []]
    for r in ranks:
        assert r["seen"] == 2 and r["steps"] == ["step_00000002"]
        assert r["seen_blocking"] == 3 and r["equal"]


def test_compressed_psum_over_the_pod_axis(elastic_world):
    """Per rank, the int8 code, scale and residual equal JAX's
    `quantize_int8` / `dequantize_int8`; the total is within 2% of the
    exact sum (the reference's check) and equals the sum of JAX's
    dequantised leaves."""
    elastic_world.check("psum")
    g = elastic_world.jax["g"]
    deq = []
    for p in range(2):
        q, s = jgc.quantize_int8(jnp.asarray(g[p]))
        deq.append(np.asarray(jgc.dequantize_int8(q, s)))
    for r in range(4):
        got = np.load(elastic_world.work / f"psum_{r}.npz")
        p = int(got["pod"])
        q, s = jgc.quantize_int8(jnp.asarray(g[p]))
        np.testing.assert_array_equal(got["q"], np.asarray(q))
        np.testing.assert_allclose(got["scale"], np.asarray(s), rtol=1e-7)
        np.testing.assert_allclose(got["err"], g[p] - deq[p], rtol=1e-7,
                                   atol=1e-7 * np.abs(g[p]).max())
        exact = g.sum(axis=0)
        rel = np.linalg.norm(got["total"] - exact) / np.linalg.norm(exact)
        assert rel < 0.02, rel
        np.testing.assert_allclose(got["total"], deq[0] + deq[1],
                                   rtol=1e-6, atol=1e-6)
