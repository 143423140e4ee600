"""The port's dry run (`repro_torch/launch/dryrun.py`, `hlo_analysis.py`)
against the JAX package's (`repro/launch/dryrun.py`, `hlo_analysis.py`).

Importing `repro.launch.dryrun` rewrites `XLA_FLAGS` (512 host devices)
for the whole process and every process it starts, so the reference runs
once, in one subprocess for the module (`REF_SCRIPT`), and prints its
values as JSON; nothing of it is imported here.  Held equal exactly:
`make_run_config`, `param_count`, `active_param_count`, `skip_reason` and
`input_specs`' shapes and dtypes for all 40 (arch x shape) cells; the
cache placements at decode_32k and long_500k on the 16x16 and 2x16x16
production meshes; each chip's argument bytes of a train_4k state.  The
FLOPs of `OpAnalysis` equal the reference's HLO walk to 1e-9 relative on
a 2-layer float32 glm4-9b prefill and training step (remat "none", the
chunked attention on both sides, one device): the reference counts dots
only, and no term differs by construction - the embedding is a gather on
both sides and the label logit a masked reduce or a gather, neither a
product.

The port's side traces fake "cpu" tensors, which any torch build runs: a
torch built without CUDA cannot run its tensor methods on fake "cuda"
ones (their device guard needs CUDA), so the card's route - the flash
op - is traced on the card's host (`chip_smoke.py` phase 19); its fake
implementation and FLOP formula are tested in
`tests/test_torch_kernels.py`.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tr
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding import partition
from repro_torch.train.train_step import init_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FLOP_TOL = 1e-9
FLOP_CFG = dict(n_layers=2, param_dtype="float32", compute_dtype="float32")
FLOP_B, FLOP_S = 2, 256

REF_SCRIPT = r'''
import dataclasses, json, sys
from repro.launch import dryrun as jd      # sets the 512-device flag first
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ARCHS, get_config
from repro.configs.base import RunConfig, SHAPES
from repro.launch import hlo_analysis
from repro.launch.mesh import make_production_mesh
from repro.models import transformer as tr
from repro.models.serve_step import make_prefill_step
from repro.optim.adamw import AdamW
from repro.sharding import partition
from repro.train.train_step import init_train_state, make_train_step


def key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)


def flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


FLOP_CFG, B, S = json.loads(sys.argv[2])
out = {"cells": {}, "cache": {}, "arg_bytes": {}}
fields = [f.name for f in dataclasses.fields(RunConfig) if f.name != "model"]
for arch in ARCHS:
    cfg = get_config(arch)
    for shape in SHAPES:
        run = jd.make_run_config(cfg, shape)
        out["cells"][f"{arch}|{shape}"] = {
            "run": {f: getattr(run, f) for f in fields},
            "param_count": jd.param_count(cfg),
            "active_param_count": jd.active_param_count(cfg),
            "skip_reason": jd.skip_reason(cfg, shape),
            "input_specs": {key(p): [list(x.shape), str(x.dtype)]
                            for p, x in flat(jd.input_specs(cfg, run))}}
for multi_pod in (False, True):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in ("decode_32k", "long_500k"):
            run = jd.make_run_config(cfg, shape)
            rules = partition.activation_rules(mesh, cfg, run)
            sh = jd.cache_shardings(jd.input_specs(cfg, run)["cache"], mesh,
                                    rules)
            out["cache"][f"{arch}|{shape}|{int(multi_pod)}"] = {
                key(p): [list(a) if isinstance(a, tuple) else a
                         for a in s.spec] for p, s in flat(sh)}
mesh = make_production_mesh()
for arch in ARCHS:
    cfg = get_config(arch)
    run = jd.make_run_config(cfg, "train_4k")
    opt = AdamW(lr=run.learning_rate, moments_dtype={
        "float32": jnp.float32, "bfloat16": jnp.bfloat16}[run.moments_dtype])
    state = jax.eval_shape(lambda k: init_train_state(k, cfg, run, opt)[0],
                           jax.random.PRNGKey(0))
    sh = partition.make_state_shardings(state, mesh, run.fsdp)
    out["arg_bytes"][arch] = sum(
        int(np.prod(s.shard_shape(x.shape))) * jnp.dtype(x.dtype).itemsize
        for x, s in zip(jax.tree.leaves(state), jax.tree.leaves(sh)))
cfg = dataclasses.replace(get_config("glm4-9b"), **FLOP_CFG)
params = jax.eval_shape(lambda k: tr.init_params(k, cfg),
                        jax.random.PRNGKey(0))
tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
comp = jax.jit(make_prefill_step(cfg, cache_len=S)).lower(
    params, {"tokens": tokens}).compile()
out["prefill_flops"] = hlo_analysis.analyze(comp.as_text())["flops"]
run = RunConfig(model=cfg, mode="train", seq_len=S, global_batch=B,
                remat="none")
opt = AdamW(lr=1e-3)
state = jax.eval_shape(lambda k: init_train_state(k, cfg, run, opt)[0],
                       jax.random.PRNGKey(0))
comp = jax.jit(make_train_step(cfg, run, opt)).lower(
    state, {"tokens": tokens, "labels": tokens}).compile()
out["train_flops"] = hlo_analysis.analyze(comp.as_text())["flops"]
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's values, from one subprocess with 512 fake XLA
    devices."""
    path = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, str(path),
         json.dumps([FLOP_CFG, FLOP_B, FLOP_S])],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _spec(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


# ------------------------- the cells, exactly ------------------------------

CELLS = [(arch, shape) for arch in ARCHS for shape in SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_equals_the_reference(ref, arch, shape):
    """Run config, parameter counts, skip reason and input specs of one
    (arch x shape) cell, exactly."""
    want = ref["cells"][f"{arch}|{shape}"]
    cfg = get_config(arch)
    run = dryrun.make_run_config(cfg, shape)
    got_run = {f.name: getattr(run, f.name)
               for f in dataclasses.fields(run) if f.name != "model"}
    assert got_run == want["run"]
    assert dryrun.param_count(cfg) == want["param_count"]
    assert dryrun.active_param_count(cfg) == want["active_param_count"]
    assert dryrun.skip_reason(cfg, shape) == want["skip_reason"]
    specs = {path: [list(x.shape), str(x.dtype).replace("torch.", "")]
             for path, x in _flat(dryrun.input_specs(cfg, run)).items()}
    assert specs == want["input_specs"]


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_shardings_equal_the_reference(ref, arch, multi_pod):
    """Each cache leaf's spec at decode_32k and long_500k on a production
    mesh over a fake world equals the reference's, and lays out the leaf
    evenly."""
    cfg = get_config(arch)
    with dryrun.fake_world(512 if multi_pod else 256):
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
        for shape in ("decode_32k", "long_500k"):
            run = dryrun.make_run_config(cfg, shape)
            rules = partition.activation_rules(mesh, cfg, run)
            cache = dryrun.input_specs(cfg, run)["cache"]
            sh = _flat(dryrun.cache_shardings(cache, mesh, rules))
            want = ref["cache"][f"{arch}|{shape}|{int(multi_pod)}"]
            assert {k: _spec(s.spec) for k, s in sh.items()} == want
            for path, leaf in _flat(cache).items():
                dryrun._local_shape(tuple(leaf.shape), mesh,
                                    sh[path].placements)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_argument_bytes_equal_the_reference(ref, arch):
    """Each chip's bytes of a train_4k state laid out on the 16x16 mesh:
    the reference's sum of `shard_shape` over its shardings."""
    cfg = get_config(arch)
    run = dryrun.make_run_config(cfg, "train_4k")
    with dryrun.fake_world(256):
        mesh = tmesh.make_production_mesh(device="cpu")
        with FakeTensorMode():
            state, _, _ = dryrun.fake_train_state(cfg, run, mesh, CPU)
            assert dryrun.local_bytes(state) == ref["arg_bytes"][arch]


# ------------------------------ the FLOPs ----------------------------------

def _flop_cfg():
    return dataclasses.replace(get_config("glm4-9b"), **FLOP_CFG)


def test_prefill_flops_equal_the_reference(ref):
    cfg = _flop_cfg()
    with FakeTensorMode():
        params = tr.init_params(torch.Generator(), cfg)
        tokens = torch.zeros((FLOP_B, FLOP_S), dtype=torch.int32)
        got = hlo_analysis.analyze(
            lambda p, t: tr.prefill(p, cfg, tokens=t, cache_len=FLOP_S,
                                    use_flash=False), params, tokens)
    assert abs(got["flops"] / ref["prefill_flops"] - 1) <= FLOP_TOL


def test_train_step_flops_equal_the_reference(ref):
    cfg = _flop_cfg()
    run = RunConfig(model=cfg, mode="train", seq_len=FLOP_S,
                    global_batch=FLOP_B, remat="none")
    opt = AdamW(lr=1e-3)
    with FakeTensorMode():
        state, _ = init_train_state(torch.Generator(), cfg, run, opt)
        tokens = torch.zeros((FLOP_B, FLOP_S), dtype=torch.int32)
        got = hlo_analysis.analyze(make_train_step(cfg, run, opt), state,
                                   {"tokens": tokens, "labels": tokens})
    assert abs(got["flops"] / ref["train_flops"] - 1) <= FLOP_TOL


# --------------------------- the per-chip rule -----------------------------

def test_a_sharded_matmul_counts_the_local_work():
    """x (64, 256) split by rows over "data" times w (256, 128) split by
    columns over "model" on a fake (2, 4) mesh: each rank multiplies a
    (32, 256) by a (256, 32) block, 1/8 of the product's FLOPs, and moves
    its blocks' bytes, with no collective; `FlopCounterMode` sees the
    global op."""
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(32, 256), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            w = DTensor.from_local(torch.empty(256, 32), mesh,
                                   [Replicate(), Shard(1)], run_check=False)
            acc, whole = hlo_analysis.OpAnalysis(), FlopCounterMode(
                display=False)
            with acc, whole:
                y = x @ w
    got = acc.result()
    assert tuple(y.shape) == (64, 128)
    assert got["flops"] == 2 * 64 * 256 * 128 / 8
    assert whole.get_total_flops() == 2 * 64 * 256 * 128
    assert got["bytes"] == 4 * (32 * 256 + 256 * 32 + 32 * 32)
    assert got["collective_bytes"] == 0


def test_an_fsdp_linear_counts_one_all_gather_of_its_shard():
    """A (64, 64) weight split by rows over 8 fake ranks (FSDP) times a
    batch split the same way: one all-gather of the rank's (8, 64) shard,
    and the local product of its 512 rows."""
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(512, 64), mesh, [Shard(0)],
                                   run_check=False)
            w = DTensor.from_local(torch.empty(8, 64), mesh, [Shard(0)],
                                   run_check=False)
            acc = hlo_analysis.OpAnalysis()
            with acc:
                y = x @ w
    got = acc.result()
    assert tuple(y.shape) == (4096, 64)
    assert got["collectives"]["all-gather"] == {"count": 1.0,
                                                "bytes": 8.0 * 64 * 4}
    assert got["collective_bytes"] == 8 * 64 * 4
    assert got["flops"] == 2 * 512 * 64 * 64


def test_shape_propagation_is_not_counted():
    """DTensor runs a fake copy of an op at global shapes to learn its
    output's shape, once a new op signature: the first call and the
    second count the same."""
    counts = []
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(16, 24), mesh, [Replicate()],
                                   run_check=False)
            w = DTensor.from_local(torch.empty(24, 10), mesh, [Shard(1)],
                                   run_check=False)
            for _ in range(2):
                acc = hlo_analysis.OpAnalysis()
                with acc:
                    x @ w
                counts.append((acc.flops, acc.bytes, dict(acc.calls)))
    assert counts[0] == counts[1]
    assert counts[0][0] == 2 * 16 * 24 * 10


def test_peak_counts_live_temporaries_beyond_the_arguments():
    def fn(a):
        b = a * 2            # 4 KiB, freed after c
        c = b + 1            # 4 KiB
        del b
        d = c.sum()
        return d
    got = hlo_analysis.analyze(fn, torch.ones(1024))
    assert got["peak_bytes"] == 2 * 4096
    assert got["flops"] == 0
    assert got["by_op"] == {"aten.mul": 8192.0, "aten.add": 8192.0,
                            "aten.sum": 4096.0 + 4.0}


def test_peak_live_names_the_largest_storages_and_a_gather_once():
    """`peak_live` lists the storages live at the peak, largest first,
    with the op that made each; a gathered tensor counts once (a fake
    tensor's wait hands back a second storage of the all-gather's
    result, which counted every gather twice)."""
    def fn(a):
        b = a * 2                                    # 4 KiB
        return torch.cat([b, b])                     # 8 KiB
    got = hlo_analysis.analyze(fn, torch.ones(1024))
    assert got["peak_bytes"] == 3 * 4096
    assert [(e["bytes"], e["op"], e["shape"]) for e in got["peak_live"]] \
        == [(8192, "aten.cat", [2048]), (4096, "aten.mul", [1024])]
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(16, 64), mesh, [Shard(0)],
                                   run_check=False)
            acc = hlo_analysis.OpAnalysis()
            with acc:
                y = x.redistribute(mesh, [Replicate()]).to_local()
    assert tuple(y.shape) == (128, 64)
    assert acc.peak_bytes == 128 * 64 * 4, acc.peak_live()
    assert acc.peak_live()[0]["op"] == "_c10d_functional.all_gather_into_tensor"


# --------------------------- the fake world --------------------------------

def test_a_mesh_over_a_fake_world_needs_no_card():
    with dryrun.fake_world(256):
        mesh = tmesh.make_production_mesh(device="cuda")
        assert mesh.device_type == "cuda" and mesh.size() == 256
    assert not dist.is_initialized()


def test_a_real_world_still_needs_its_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tmesh.make_host_mesh(1, 1, device="cuda")
    assert not dist.is_initialized()


def test_the_fake_world_refuses_a_stale_group():
    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="exists already"):
            with dryrun.fake_world(4):
                pass
    assert not dist.is_initialized()


# ------------------------------- the cells ---------------------------------

def test_production_cell_on_a_fake_256_rank_world(tmp_path, monkeypatch):
    """The CLI's cell: mamba2-130m decode_32k on the 16x16 mesh of a fake
    256-rank world, its report written as the reference's."""
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                 "--device", "cpu", "--force"])
    with open(tmp_path / "mamba2-130m__decode_32k__16x16.json") as f:
        r = json.load(f)
    assert "error" not in r, r.get("error")
    assert r["n_chips"] == 256 and r["mesh"] == "16x16"
    assert r["flops_per_chip"] > 0 and r["dominant"] is not None
    assert r["memory"]["argument_bytes"] > 0
    assert r["memory"]["generated_code_bytes"] is None
    assert set(r["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert not dist.is_initialized()


def test_ssd_decode_on_the_512_rank_mesh():
    """mamba2-130m's decode_32k on 2x16x16: DTensor's einsum rules split
    the SSD's 24 heads over the 16-wide "model" axis unevenly and then
    refused to flatten them, where the reference lowers; the recurrence
    now runs on each rank's batch rows (`models/ssm.ssm_decode`)."""
    r = dryrun.lower_cell("mamba2-130m", "decode_32k", multi_pod=True,
                          device="cpu")
    assert r["n_chips"] == 512 and r["mesh"] == "2x16x16"
    assert r["flops_per_chip"] > 0 and r["dominant"] is not None


def _small(arch, **kw):
    return dataclasses.replace(get_config(arch), **dict(dict(
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, param_dtype="float32",
        compute_dtype="float32"), **kw))


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_a_one_rank_trace_counts_what_the_real_step_counts(mode):
    """Phase 19's check on the host: the dry run's trace of a step on a
    fake one-rank mesh counts the FLOPs `FlopCounterMode` counts on the
    real unsharded step (microbatches and remat "dots" in training)."""
    arch = "stablelm-1.6b" if mode == "train" else "glm4-9b"
    cfg = _small(arch)
    if mode == "train":
        run = RunConfig(model=cfg, mode="train", seq_len=32, global_batch=4,
                        microbatch=2)
        state, opt = init_train_state(torch.Generator().manual_seed(0), cfg,
                                      run)
        step, args = make_train_step(cfg, run, opt), (state, {
            "tokens": torch.zeros((4, 32), dtype=torch.int32),
            "labels": torch.zeros((4, 32), dtype=torch.int32)})
    else:
        run = RunConfig(model=cfg, mode="prefill", seq_len=32,
                        global_batch=2)
        params = tr.init_params(torch.Generator().manual_seed(0), cfg)
        step = (lambda p, b: tr.prefill(p, cfg, tokens=b["tokens"],
                                        cache_len=32))
        args = (params, {"tokens": torch.zeros((2, 32), dtype=torch.int32)})
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad() if mode == "prefill" else \
            torch.enable_grad():
        step(*args)
    r = dryrun.lower_cell(arch, "train_4k" if mode == "train"
                          else "prefill_32k", run_override=run,
                          mesh_shape=(1, 1), device="cpu")
    assert r["n_chips"] == 1
    assert r["flops_per_chip"] == counter.get_total_flops() > 0


# ------------------- sharded training steps on fake worlds ------------------

def _train_cell(arch, mesh_shape, cfg, **kw):
    run = RunConfig(model=cfg, mode="train", seq_len=64, global_batch=32,
                    microbatch=16, fsdp=True, **kw)
    return dryrun.lower_cell(arch, "train_4k", run_override=run,
                             mesh_shape=mesh_shape, device="cpu")


def _split_cell(arch, cfg, mesh_shape=(4, 2), **kw):
    """A microbatched train cell on a fake 8-rank world ((4, 2) by
    default) and on one rank: (the 8-rank report, its FLOPs over an
    eighth of the one rank's)."""
    one = _train_cell(arch, (1, 1), cfg, **kw)
    r = _train_cell(arch, mesh_shape, cfg, **kw)
    assert r["n_chips"] == 8 and r["flops_per_chip"] > 0
    return r, r["flops_per_chip"] / (one["flops_per_chip"] / 8)


def test_microbatches_and_the_loss_stay_split():
    """A stablelm-shaped step of two microbatches of 16 x 64 tokens on a
    fake (4, 2) ("data", "model") world: each chip counts an eighth of
    the one-rank trace's FLOPs (2%), and its peak stays under the bytes
    of one whole (microbatch, S, V) float32 tensor.  Slicing a microbatch
    out of the split batch would gather it whole (DTensor slices a split
    dim by gathering it), and a one-hot of whole labels would force the
    vocabulary-split logits whole: 1.13 x the FLOPs and such a tensor on
    every rank."""
    cfg = _small("stablelm-1.6b")
    r, ratio = _split_cell("stablelm-1.6b", cfg, remat="full")
    assert abs(ratio - 1) <= 0.02, ratio
    whole_logits = 16 * 64 * 512 * 4
    assert r["memory"]["peak_bytes"] < whole_logits, r["memory"]


@pytest.mark.parametrize("arch,fields,kw", [
    ("stablelm-1.6b", {}, {"seq_shard": True, "remat": "dots"}),
    ("recurrentgemma-2b", {"n_heads": 5, "kv_heads": 1, "lru_width": 64,
                           "local_window": 16, "n_layers": 3},
     {"remat": "full"})], ids=["megatron_sp", "context_parallel"])
def test_a_step_with_a_split_sequence_traces(arch, fields, kw):
    """The sequence split over "model": by Megatron-SP (`seq_shard`), and
    by context parallelism (a recurrentgemma-shaped model, RG-LRU blocks
    and windowed attention, whose 5 heads do not divide the model axis).
    Both trace forward and backward, each chip counting an eighth of the
    one-rank FLOPs.  DTensor's own matmul rule refuses Megatron-SP's
    flatten of a (B, S, d) split along B and S, and a whole q would
    attend every query on every rank of the model axis."""
    cfg = _small(arch, **fields)
    _, ratio = _split_cell(arch, cfg, **kw)
    assert abs(ratio - 1) <= 0.02, ratio


@pytest.mark.parametrize("mesh_shape,state", [((4, 2), 16), ((2, 4), 17)],
                         ids=["split_in_projection", "whole_in_projection"])
def test_an_ssd_step_shares_its_heads_over_the_model_axis(mesh_shape,
                                                          state):
    """A mamba2-shaped step (16 heads of 8, 2 SSD chunks a row) on a fake
    8-rank world: each "model" rank runs its share of the channels on
    its rows and its share of the chunks' C B^T products (ceil(2 / 4) = 1
    on the 4-wide axis: 1.3% over an eighth), an eighth of the one-rank
    FLOPs, where every rank of "model" had repeated the C B^T products
    (5%; 3.9% on the 4-wide axis).  With 17 states the in-projection's
    306 features do not divide the 4-wide model axis, so the parameter
    rules keep it
    whole there, as mamba2-130m's 3352 on 16, and its product runs on a
    share of the sequence.  DTensor's own rules raise in the SSD's
    products (the flattened, split heads) and, on torch 2.11, in the
    causal convolution's `F.pad`."""
    cfg = _small("mamba2-130m", d_ff=0, n_heads=0, kv_heads=0,
                 ssm_state=state, ssm_head_dim=8, ssm_chunk=32)
    _, ratio = _split_cell("mamba2-130m", cfg, mesh_shape, remat="dots")
    assert abs(ratio - 1) <= 0.02, ratio


def test_a_moe_step_shares_the_router_over_the_model_axis():
    """A phi3.5-shaped MoE step (4 experts, four dispatch groups of 256
    tokens, one a "data" rank) on a fake (4, 2) world counts an eighth of
    the one-rank FLOPs to 1e-4: each rank of "model" multiplies its half
    of the group's tokens by the router and differentiates that half,
    where each had routed all of them (+0.21% here; phi3.5-moe train_4k
    +0.09% and llama4-maverick +1.5% a chip against the reference's).
    The experts' work splits evenly: the groups' capacities sum to the
    one-rank buffer's."""
    cfg = _small("phi3.5-moe-42b-a6.6b", n_experts=4)
    r, ratio = _split_cell("phi3.5-moe-42b-a6.6b", cfg)
    assert abs(ratio - 1) <= 1e-4, ratio
    assert "aten.mm f32[128,4]" in r["flops_by_op"], r["flops_by_op"]


# ------------------------ the reference's slow pair ------------------------

def _run_sub(code: str, timeout: int = 560) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


@pytest.mark.slow
def test_dryrun_cell_compiles_on_production_mesh():
    """One real dry-run cell: a fake 256-rank world, 16x16 mesh, decode
    shape (`tests/test_dryrun_sharding.py:29`)."""
    out = _run_sub("""
from repro_torch.launch.dryrun import lower_cell
r = lower_cell('mamba2-130m', 'decode_32k', device='cpu')
assert r['n_chips'] == 256, r
assert r['flops_per_chip'] > 0
assert r['dominant'] is not None
print('OK', r['dominant'])
""")
    assert "OK" in out


# The reference's train_4k FLOPs a chip on 16x16
# (`probes/ref_dryrun_train.py`) and the tolerance each is held to:
# stablelm-1.6b's equals phase 15's count on the card scaled from (8,
# 4096) tokens on one chip to (256, 4096) on 256; llama4-maverick, the
# train cell `chip_smoke.py` phase 19 leaves out for its trace's time,
# counts the reference's since each rank of "model" routes a share of a
# group's tokens (1.015x while each routed all of them).
TRAIN_CELLS = {"stablelm-1.6b": (4.8550310313984e13, 1e-3),
               "llama4-maverick-400b-a17b": (5.0425063538688e14, 1e-3)}


@pytest.mark.slow
@pytest.mark.parametrize("arch", list(TRAIN_CELLS))
def test_train_cell_fits_on_the_production_mesh(arch):
    """A train_4k cell on a fake 256-rank world, 16x16: each chip peaks
    under an H100's 80 GB and counts the reference's FLOPs (stablelm
    traced at 139.079 GB and 1.0731e14 while every rank held each
    microbatch's logits whole and repeated its products)."""
    flops, tol = TRAIN_CELLS[arch]
    out = _run_sub(f"""
from repro_torch.launch.dryrun import lower_cell
r = lower_cell({arch!r}, 'train_4k', device='cpu')
assert r['n_chips'] == 256, r
peak = r['memory']['peak_bytes']
assert peak < 80e9, peak
rel = abs(r['flops_per_chip'] / {flops!r} - 1)
assert rel <= {tol!r}, (r['flops_per_chip'], rel)
print('OK train', peak, r['flops_per_chip'])
""", timeout=1500)
    assert "OK train" in out


@pytest.mark.slow
def test_solver_cell_compiles_on_production_mesh():
    """The paper-technique cell: the distributed BlockAMC solver traced at
    256 chips (`tests/test_dryrun_sharding.py:153`)."""
    out = _run_sub("""
from repro_torch.launch.dryrun import lower_solver_cell
r = lower_solver_cell(n=2048, stages=1, device='cpu')
assert r['n_chips'] == 256
assert r['flops_per_chip'] > 0
print('OK solver', r['dominant'])
""")
    assert "OK solver" in out
