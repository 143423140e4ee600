"""GPipe pipeline parallelism in the port (`train/pipeline.py`) against the
sequential stack and the reference's `pipeline_apply`.

Four gloo ranks in subprocesses over a `FileStore` run S=4 stages of a
tanh stack (M=8 microbatches of (2, 16), L=8 layers, numpy draws); the
reference's `pipeline_apply` runs under `shard_map` in a subprocess with
four XLA host devices on a mesh of `AxisType.Auto` axes (on jax 0.9
`jax.make_mesh` defaults to Explicit axes, under which the reference's
own `tests/test_pipeline.py` script fails before reaching the pipeline;
`pipeline_apply` itself is unchanged).  Tolerances are the reference's:
the forward 2e-5, the gradients 2e-4.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_mc_mesh
from repro_torch.train import pipeline as tpipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, M, B, D, L = 4, 8, 2, 16, 8

JAX_PIPE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from functools import partial
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.train.pipeline import pipeline_apply, split_stages

S, L, D = 4, 8, 16
data = np.load(sys.argv[1])
w, x = jnp.asarray(data["w"]), jnp.asarray(data["x"])
mesh = jax.make_mesh((S,), ('pp',), axis_types=(jax.sharding.AxisType.Auto,))

def stage_fn(stage_w, h):
    def body(h, wi):
        return jnp.tanh(h @ wi), None
    h, _ = jax.lax.scan(body, h, stage_w)
    return h

@partial(shard_map, mesh=mesh, in_specs=(P('pp'), P(None)),
         out_specs=P('pp'), check_rep=False)
def pipe(w_local, x_all):
    out = pipeline_apply(lambda p, h: stage_fn(p[0], h), w_local, x_all, 'pp')
    return out[None]

w_staged = split_stages(w, S)
outs = pipe(w_staged, x)
g = jax.grad(lambda ws, x: jnp.sum(pipe(ws, x)[-1] ** 2))(w_staged, x)
np.savez(sys.argv[2], outs=np.asarray(outs[-1]),
         grad=np.asarray(g).reshape(L, D, D))
"""


def _draws():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(L, D, D)) * (0.5 / np.sqrt(D))).astype(np.float32)
    x = rng.normal(size=(M, B, D)).astype(np.float32)
    return w, x


def _sequential(w, x):
    """The stack applied to each microbatch, and d sum(out^2) / dw."""
    w = torch.from_numpy(w).requires_grad_()
    h = torch.from_numpy(x)
    for wi in w:
        h = torch.tanh(h @ wi)
    (h ** 2).sum().backward()
    return h.detach().numpy(), w.grad.numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks and the JAX subprocess, started together."""
    work = tmp_path_factory.mktemp("pipeline")
    w, x = _draws()
    np.savez(work / "in.npz", w=w, x=x)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(                  # niced: yield the CPU
        ["nice", "-n", "10", sys.executable,
         os.path.join(REPO, "tests", "_torch_mesh_ranks.py"),
         "pipeline", str(work / "store"), str(work)],
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(S)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", JAX_PIPE, str(work / "in.npz"),
         str(work / "jax.npz")],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    ranks = [np.load(work / f"pipeline_{r}.npz") for r in range(S)]
    return w, x, ranks, np.load(work / "jax.npz")


def test_pipeline_forward_matches_sequential_and_jax(runs):
    w, x, ranks, jax_out = runs
    want, _ = _sequential(w, x)
    by_stage = {int(r["stage"]): r for r in ranks}
    assert sorted(by_stage) == list(range(S))
    got = by_stage[S - 1]["outs"]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, jax_out["outs"], rtol=2e-5, atol=2e-5)
    for s in range(S - 1):            # zeros off the last stage
        assert not by_stage[s]["outs"].any()


def test_pipeline_gradients_match_sequential_and_jax(runs):
    w, x, ranks, jax_out = runs
    _, want = _sequential(w, x)
    by_stage = {int(r["stage"]): r for r in ranks}
    got = np.concatenate([by_stage[s]["grad"] for s in range(S)])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, jax_out["grad"], rtol=2e-4, atol=2e-4)


def test_split_stages_cuts_the_layer_axis():
    w = torch.arange(8 * 3).reshape(8, 3)
    tree = tpipe.split_stages({"a": {"w": w}}, 4)
    assert tuple(tree["a"]["w"].shape) == (4, 2, 3)
    assert torch.equal(tree["a"]["w"][1], w[2:4])
    with pytest.raises(ValueError, match="do not split"):
        tpipe.split_stages(w, 3)


def test_one_stage_pipeline_is_the_stack_forward_and_backward():
    """S = 1: the ring passes each value to itself with no collective."""
    w, x = _draws()
    want, want_g = _sequential(w, x)
    assert not dist.is_initialized()
    try:
        mesh = make_mc_mesh(axis_name="pp", device="cpu")
        ws = torch.from_numpy(w).requires_grad_()

        def stage_fn(p, h):
            for wi in p:
                h = torch.tanh(h @ wi)
            return h
        outs = tpipe.pipeline_apply(stage_fn, ws, torch.from_numpy(x), mesh,
                                    "pp")
        (outs ** 2).sum().backward()
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(outs.detach().numpy(), want, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(ws.grad.numpy(), want_g, rtol=2e-4, atol=2e-4)
