"""One gloo rank of the language model's mesh checks, run as a subprocess
by `tests/test_torch_lm_mesh.py` and `tests/test_torch_pipeline.py`:

    python tests/_torch_mesh_ranks.py <world> <store file> <work dir>

with RANK in the environment.  `world` picks the checks: "lm" (8 ranks,
a (4, 2) ("data", "model") mesh), "elastic" (4 ranks) or "pipeline" (4
ranks).  Inputs the parent made with the JAX package (weights, draws)
come as `<work dir>/in.npz`; each check writes its numbers to
`<work dir>/<check>.json` (rank 0) and its per-rank arrays to
`<work dir>/<check>_<rank>.npz`.  A check that raises records its error
and the rank goes on to the next, so every check is a test of its own.
Imports nothing of JAX.
"""
import dataclasses
import datetime
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import (CheckpointManager, flatten,
                                         latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tr
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.grad_compression import (compressed_psum,
                                                dequantize_int8,
                                                quantize_int8)
from repro_torch.runtime.elastic import ElasticMesh
from repro_torch.sharding import api, partition as pt
from repro_torch.train import pipeline as tpipe
from repro_torch.train.train_step import OptState, make_train_step
from repro_torch.tree import tree_leaves

RANK = WORK = None          # set by main()
SIZES = {"lm": 8, "elastic": 4, "pipeline": 4}

# the reference's sharded-step config (tests/test_dryrun_sharding.py:42-85)
DENSE = dict(n_layers=2, d_model=64, d_ff=128, vocab=512, n_heads=4,
             kv_heads=2, head_dim=16, param_dtype="float32",
             compute_dtype="float32")
# three heads do not divide the model axis: the context-parallel rule
CONTEXT = dict(DENSE, n_heads=3, kv_heads=1)
MOE = dict(DENSE, n_experts=4)


def cfg_of(arch, fields):
    return dataclasses.replace(get_config(arch), **fields)


def nested(flat: dict, prefix: str) -> dict:
    """The nested dict of `flat`'s entries under `prefix/`."""
    out = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def state_from(inputs, name):
    params = nested(inputs, f"{name}/params")
    opt = OptState(step=inputs[f"{name}/step"],
                   m=nested(inputs, f"{name}/m"),
                   v=nested(inputs, f"{name}/v"))
    return interop.train_state_from_numpy(params, opt, device="cpu")


def errors(got, want):
    """(worst leaf's max |got - want|, the largest |want| of the tree,
    the worst leaf's error of its own max|want|)."""
    worst = scale = own = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a = api.whole(a).float()
        b = b.float()
        err = float((a - b).abs().max())
        worst = max(worst, err)
        scale = max(scale, float(b.abs().max()))
        own = max(own, err / max(float(b.abs().max()), 1e-30))
    return worst, scale, own


def batch_on(mesh, batch):
    return {key: pt.distribute(x, pt.NamedSharding(mesh, pt.P("data")))
            for key, x in batch.items()}


def sharded_step(mesh, cfg, run, state, batch, grad_shardings):
    opt = AdamW(lr=1e-3)
    plain, pm = make_train_step(cfg, run, opt)(state, batch)
    with api.policy_scope(pt.make_policy(mesh, cfg, run)):
        placed = pt.distribute(state, pt.make_state_shardings(state, mesh,
                                                              run.fsdp))
        gsh = (pt.make_param_shardings(state.params, mesh, run.fsdp)
               if grad_shardings else None)
        step = make_train_step(cfg, run, opt, grad_shardings=gsh)
        t0 = time.perf_counter()
        new, m = step(placed, batch_on(mesh, batch))
        wall = time.perf_counter() - t0
    worst, scale, own = errors(new.params, plain.params)
    m_err = errors(new.opt.m, plain.opt.m)
    return {"loss": float(m["loss"]), "plain_loss": float(pm["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "plain_grad_norm": float(pm["grad_norm"]),
            "metric_types": sorted({type(v).__name__ for v in m.values()}),
            "param_err": worst, "param_scale": scale, "param_own": own,
            "m_err": m_err[0], "m_scale": m_err[1],
            "placements": str(new.params["blocks"]["b0"]["mix"]["wq"]
                              .placements),
            "wall_s": wall}


def check_train(mesh, inputs):
    cfg = cfg_of("glm4-9b", DENSE)
    run = RunConfig(model=cfg, mode="train", seq_len=32, global_batch=8,
                    remat="dots", fsdp=True)
    batch = SyntheticLM(cfg, run, seed=1, device="cpu").batch(0)
    return sharded_step(mesh, cfg, run, state_from(inputs, "dense"), batch,
                        False)


def check_train_micro(mesh, inputs):
    cfg = cfg_of("glm4-9b", DENSE)
    run = RunConfig(model=cfg, mode="train", seq_len=32, global_batch=8,
                    microbatch=4, remat="dots", fsdp=True)
    batch = SyntheticLM(cfg, run, seed=1, device="cpu").batch(0)
    return sharded_step(mesh, cfg, run, state_from(inputs, "dense"), batch,
                        True)


def forward_err(mesh, cfg, run, params, tokens, **kw):
    want, _ = tr.forward(params, cfg, tokens=tokens, **kw)
    with api.policy_scope(pt.make_policy(mesh, cfg, run)):
        placed = pt.distribute(params, pt.make_param_shardings(
            params, mesh, run.fsdp))
        got, _ = tr.forward(placed, cfg, tokens=pt.distribute(
            tokens, pt.batch_sharding(mesh, cfg, run)), **kw)
        rules = pt.activation_rules(mesh, cfg, run)
    err = float((api.whole(got) - want).abs().max())
    return err, float(want.abs().max()), str(got.placements), rules


def check_context_parallel(mesh, inputs):
    cfg = cfg_of("glm4-9b", CONTEXT)
    run = RunConfig(model=cfg, mode="train", seq_len=32, global_batch=8,
                    remat="dots", fsdp=True)
    state = state_from(inputs, "context")
    tokens = SyntheticLM(cfg, run, seed=2, device="cpu").batch(0)["tokens"]
    out = {}
    for route, flag in (("chunked", False), ("flash", True)):
        err, scale, place, rules = forward_err(mesh, cfg, run, state.params,
                                               tokens, use_flash=flag)
        out[f"{route}_err"], out["logit_scale"] = err, scale
    out["act_kv"], out["act_q"] = str(rules["act_kv"]), str(rules["act_q"])
    batch = SyntheticLM(cfg, run, seed=1, device="cpu").batch(0)
    out.update(sharded_step(mesh, cfg, run, state, batch, True))
    return out


def check_moe(mesh, inputs):
    cfg = cfg_of("phi3.5-moe-42b-a6.6b", MOE)
    run = RunConfig(model=cfg, mode="train", seq_len=32, global_batch=8)
    params = state_from(inputs, "moe").params
    tokens = SyntheticLM(cfg, run, seed=2, device="cpu").batch(0)["tokens"]
    policy = pt.make_policy(mesh, cfg, run)
    with api.policy_scope(api.ShardingPolicy(None, {}, dict(policy.meta))):
        want, _ = tr.forward(params, cfg, tokens=tokens)   # same groups
    with api.policy_scope(policy):
        placed = pt.distribute(params, pt.make_param_shardings(
            params, mesh, run.fsdp))
        got, _ = tr.forward(placed, cfg, tokens=pt.distribute(
            tokens, pt.batch_sharding(mesh, cfg, run)))
    return {"err": float((api.whole(got) - want).abs().max()),
            "logit_scale": float(want.abs().max()),
            "dp_groups": policy.meta["dp_groups"],
            "act_gecd": str(policy.rules.get("act_gecd"))}


def check_decode(mesh, inputs):
    cfg = cfg_of("glm4-9b", DENSE)
    run = RunConfig(model=cfg, mode="decode", seq_len=24, global_batch=8)
    params = state_from(inputs, "dense").params
    tokens = SyntheticLM(cfg, run, seed=3, device="cpu").batch(0)["tokens"]
    prompt = tokens[:, :16]
    out = {"err": 0.0, "ids_equal": True}
    with torch.no_grad():
        want, cache = tr.prefill(params, cfg, tokens=prompt, cache_len=24,
                                 cache_dtype=torch.float32)
        with api.policy_scope(pt.make_policy(mesh, cfg, run)):
            placed = pt.distribute(params, pt.make_param_shardings(
                params, mesh, run.fsdp))
            got, sh_cache = tr.prefill(
                placed, cfg, tokens=pt.distribute(
                    prompt, pt.batch_sharding(mesh, cfg, run)),
                cache_len=24, cache_dtype=torch.float32)
            out["cache_placements"] = str(
                sh_cache["blocks"]["b0"]["k"].placements)
            scale = float(want.abs().max())
            for i in range(5):
                got = api.whole(got)
                out["err"] = max(out["err"],
                                 float((got - want).abs().max()) / scale)
                ids, sh_ids = want.argmax(-1), got.argmax(-1)
                out["ids_equal"] &= bool(torch.equal(ids, sh_ids))
                if i == 4:
                    break
                want, cache = tr.decode_step(params, cache, ids, 16 + i, cfg)
                got, sh_cache = tr.decode_step(placed, sh_cache, ids, 16 + i,
                                               cfg)
                scale = float(want.abs().max())
            out["cache_err"] = max(
                float((api.whole(a) - b).abs().max())
                for a, b in zip(tree_leaves(sh_cache), tree_leaves(cache)))
    return out


def small(arch):
    """`arch` at `tests/conftest.py::reduce_cfg`'s size (its topology
    kept), without importing the JAX package."""
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, n_layers=4 if not cfg.layer_pattern
        else 2 * len(cfg.layer_pattern), d_model=64,
        d_ff=128 if cfg.d_ff else 0, vocab=512,
        n_heads=4 if cfg.n_heads else 0,
        kv_heads=min(cfg.kv_heads, 2) if cfg.kv_heads else 0, head_dim=16,
        lru_width=64 if cfg.lru_width else None,
        n_experts=4 if cfg.n_experts else 0, local_window=8, ssm_state=16,
        ssm_head_dim=8, ssm_chunk=4, param_dtype="float32",
        compute_dtype="float32")


def check_families(mesh, inputs):
    """The SSD, RG-LRU (windowed attention) and interleaved-MoE families:
    forward, prefill and a decode step under the policy against the
    unsharded model with the same dispatch groups, each error a fraction
    of its max|logit|."""
    out = {}
    for arch in ("mamba2-130m", "recurrentgemma-2b",
                 "llama4-maverick-400b-a17b"):
        cfg = small(arch)
        run = RunConfig(model=cfg, mode="train", seq_len=16, global_batch=8,
                        fsdp=True)
        params = tr.init_params(torch.Generator().manual_seed(0), cfg)
        tokens = SyntheticLM(cfg, run, seed=4, device="cpu").batch(0)[
            "tokens"]
        policy = pt.make_policy(mesh, cfg, run)

        def run_model(p, toks):
            with torch.no_grad():
                logits, _ = tr.forward(p, cfg, tokens=toks)
                last, cache = tr.prefill(p, cfg, tokens=toks, cache_len=20,
                                         cache_dtype=torch.float32)
                step, _ = tr.decode_step(p, cache, api.whole(last).argmax(-1),
                                         16, cfg)
            return [api.whole(x) for x in (logits, last, step)]
        with api.policy_scope(api.ShardingPolicy(None, {},
                                                 dict(policy.meta))):
            want = run_model(params, tokens)
        with api.policy_scope(policy):
            got = run_model(pt.distribute(params, pt.make_param_shardings(
                params, mesh, run.fsdp)), pt.distribute(
                    tokens, pt.batch_sharding(mesh, cfg, run)))
        out[arch] = max(float((g - w).abs().max() / w.abs().max())
                        for g, w in zip(got, want))
    return out


def check_elastic(inputs):
    cfg = cfg_of("glm4-9b", DENSE)
    state = state_from(inputs, "dense")
    mesh_a = make_host_mesh(2, 2, device="cpu")
    placed = pt.distribute(state, pt.make_state_shardings(state, mesh_a,
                                                          True))
    save_checkpoint(os.path.join(WORK, "ckpt"), 3, placed)
    em = ElasticMesh()
    mesh_b = em.make_mesh(model_divisors=(64,), device="cpu")
    sh_b = pt.make_state_shardings(state, mesh_b, True)
    restored = restore_checkpoint(os.path.join(WORK, "ckpt"), 3, state,
                                  sharding_tree=sh_b)
    equal, slices = True, True
    coord = dict(zip(mesh_b.mesh_dim_names, mesh_b.get_coordinate()))
    for (key, got), (_, want), (_, sh) in zip(
            flatten(restored), flatten(state), flatten(sh_b)):
        equal &= bool(torch.equal(api.whole(got), want))
        slices &= bool(torch.equal(got.to_local(), local_slice(
            want, sh.spec, pt.mesh_axes(mesh_b), coord)))
    return {"choose_shape": list(em.choose_shape(4, model_divisors=(64,))),
            "mesh": list(mesh_b.shape), "names": list(mesh_b.mesh_dim_names),
            "equal": equal, "slices": slices,
            "n_leaves": len(list(flatten(state)))}


def check_manager(inputs):
    """`CheckpointManager` on a (2, 2) mesh: every rank gathers, rank 0
    alone writes and collects old steps, and after `wait` every rank sees
    the last step and restores it equal."""
    state = state_from(inputs, "dense")
    mesh = make_host_mesh(2, 2, device="cpu")
    placed = pt.distribute(state, pt.make_state_shardings(state, mesh,
                                                          True))
    where = os.path.join(WORK, "managed")
    calls = []
    real = ckpt.save_checkpoint

    def counted(*args, **kw):
        calls.append(args[1])
        return real(*args, **kw)
    ckpt.save_checkpoint = counted
    try:
        mgr = CheckpointManager(where, every=1, keep=1)
        mgr.maybe_save(1, placed)
        mgr.maybe_save(2, placed)
        mgr.wait()
        seen = latest_step(where)
        steps = sorted(os.listdir(where))
        mgr.maybe_save(3, placed, blocking=True)
        seen_blocking = latest_step(where)
    finally:
        ckpt.save_checkpoint = real
    back = restore_checkpoint(where, 3, state)
    equal = all(torch.equal(a, w) for (_, a), (_, w)
                in zip(flatten(back), flatten(state)))
    mine = {"writes": calls, "seen": seen, "steps": steps,
            "seen_blocking": seen_blocking, "equal": equal}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return {"ranks": every}


def local_slice(x, spec, sizes, coord):
    """The block of `x` a rank at mesh coordinate `coord` holds under
    `spec`, by JAX's rule: a dim split over axes (a, b, ...) is cut in
    size(a) * size(b) * ... blocks, the first axis major."""
    index = []
    for dim, ax in enumerate(tuple(spec) + (None,) * (x.dim() - len(spec))):
        if ax is None:
            index.append(slice(None))
            continue
        group = ax if isinstance(ax, tuple) else (ax,)
        block, count = 0, 1
        for a in group:
            block, count = block * sizes[a] + coord[a], count * sizes[a]
        n = x.shape[dim] // count
        index.append(slice(block * n, (block + 1) * n))
    return x[tuple(index)]


def check_psum(inputs):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    pod = mesh.get_local_rank("pod")
    g = torch.from_numpy(inputs["psum/g"][pod])
    total, err = compressed_psum({"g": g}, mesh, "pod",
                                 {"g": torch.zeros_like(g)})
    q, scale = quantize_int8(g)
    np.savez(os.path.join(WORK, f"psum_{RANK}.npz"), pod=pod,
             q=q.numpy(), scale=scale.numpy(),
             deq=dequantize_int8(q, scale).numpy(),
             total=total["g"].numpy(), err=err["g"].numpy())
    return {"pod": pod}


def check_pipeline(inputs):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("pp",))
    w = torch.from_numpy(inputs["w"])
    x = torch.from_numpy(inputs["x"])
    stage = mesh.get_local_rank("pp")
    mine = tpipe.split_stages(w, 4)[stage].clone().requires_grad_()

    def stage_fn(p, h):
        for wi in p:
            h = torch.tanh(h @ wi)
        return h

    outs = tpipe.pipeline_apply(stage_fn, mine, x, mesh, "pp")
    (outs ** 2).sum().backward()
    np.savez(os.path.join(WORK, f"pipeline_{RANK}.npz"), stage=stage,
             outs=outs.detach().numpy(), grad=mine.grad.numpy())
    return {"stage": stage}


def main():
    global RANK, WORK
    RANK = int(os.environ["RANK"])
    WORLD, STORE, WORK = sys.argv[1], sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(STORE,
                                                         SIZES[WORLD]),
                            rank=RANK, world_size=SIZES[WORLD],
                            timeout=datetime.timedelta(seconds=120))
    inputs = dict(np.load(os.path.join(WORK, "in.npz")))
    if WORLD == "lm":
        mesh = make_host_mesh(4, 2, device="cpu")
        checks = {name: (lambda fn: lambda: fn(mesh, inputs))(fn)
                  for name, fn in (("train", check_train),
                                   ("train_micro", check_train_micro),
                                   ("context_parallel",
                                    check_context_parallel),
                                   ("moe", check_moe),
                                   ("decode", check_decode),
                                   ("families", check_families))}
    elif WORLD == "elastic":
        checks = {"elastic": lambda: check_elastic(inputs),
                  "psum": lambda: check_psum(inputs),
                  "manager": lambda: check_manager(inputs)}
    else:
        checks = {"pipeline": lambda: check_pipeline(inputs)}
    for name, run in checks.items():
        t0 = time.perf_counter()
        try:
            result = run()
        except Exception:                    # recorded, not swallowed:
            result = {"error": traceback.format_exc()}   # the test fails
        result["seconds"] = time.perf_counter() - t0
        if RANK == 0 or "error" in result:
            path = os.path.join(WORK, f"{name}.json")
            if RANK != 0:
                path = os.path.join(WORK, f"{name}.rank{RANK}.json")
            with open(path, "w") as f:
                json.dump(result, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
