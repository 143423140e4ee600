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
from repro_torch.train import train_step as ts
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
            "placements": str(next(
                w for name, w in new.params["blocks"]["b0"]["mix"].items()
                if name in ("wq", "in_proj")).placements),
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


def pad_labels(labels):
    """Labels padded (-1) unevenly across the two microbatches of four
    rows: 48 pads in the first, 2 in the second.  The loss's denominator
    is counted per microbatch, so any other grouping of the rows changes
    the loss.  Works in place on a numpy array or a tensor."""
    labels[0:4, 20:] = -1
    labels[5, 30:] = -1
    return labels


def check_train_seq(mesh, inputs):
    """Megatron-SP (the sequence split over "model"), microbatches and
    labels padded unevenly across them."""
    cfg = cfg_of("glm4-9b", DENSE)
    run = RunConfig(model=cfg, mode="train", seq_len=32, global_batch=8,
                    microbatch=4, remat="dots", fsdp=True, seq_shard=True)
    batch = SyntheticLM(cfg, run, seed=1, device="cpu").batch(0)
    batch["labels"] = pad_labels(batch["labels"])
    seen, loss_fn = [], ts.loss_fn

    def recording(params, micro, *args, **kw):
        seen.append(str(getattr(micro["labels"], "placements", "plain")))
        return loss_fn(params, micro, *args, **kw)
    ts.loss_fn = recording
    try:
        out = sharded_step(mesh, cfg, run, state_from(inputs, "dense"),
                           batch, True)
    finally:
        ts.loss_fn = loss_fn
    out["act_btd"] = str(pt.activation_rules(mesh, cfg, run)["act_btd"])
    out["labels_seen"] = seen
    return out


def check_split_rows(mesh, inputs):
    """`api.split_rows` of a (32, 3) batch split over "data" (4 ranks)
    into n = 2, 4, 8 parts (fewer, as many and more parts than ranks) and
    16 (parts of 2 rows, which 4 ranks cannot split): each part's rows
    are the reshape's, and `take` gives part i whole."""
    x = torch.arange(96).reshape(32, 3)
    placed = pt.distribute(x, pt.NamedSharding(mesh, pt.P("data")))
    out = {}
    for n in (2, 4, 8, 16):
        parts = api.split_rows(placed, n)
        want = x.reshape(n, 32 // n, 3)
        out[f"equal_{n}"] = bool(torch.equal(api.whole(parts), want))
        out[f"place_{n}"] = str(parts.placements)
        out[f"take_{n}"] = all(
            torch.equal(api.whole(api.take(parts, i)), want[i])
            for i in range(n))
        out[f"take_place_{n}"] = str(api.take(parts, 0).placements)
    return out


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


def check_train_moe(mesh, inputs):
    """A phi3.5-shaped MoE step under the policy (FSDP, grad_shardings):
    four dispatch groups, one a "data" rank, routed on each rank's rows,
    against the unsharded step with the same group count."""
    cfg = cfg_of("phi3.5-moe-42b-a6.6b", MOE)
    run = RunConfig(model=cfg, mode="train", seq_len=32, global_batch=8,
                    remat="dots", fsdp=True)
    state = state_from(inputs, "moe")
    batch = SyntheticLM(cfg, run, seed=1, device="cpu").batch(0)
    policy = pt.make_policy(mesh, cfg, run)
    opt = AdamW(lr=1e-3)
    with api.policy_scope(api.ShardingPolicy(None, {}, dict(policy.meta))):
        plain, pm = make_train_step(cfg, run, opt)(state, batch)
    with api.policy_scope(policy):
        placed = pt.distribute(state, pt.make_state_shardings(state, mesh,
                                                              run.fsdp))
        step = make_train_step(cfg, run, opt, grad_shardings=pt.
                               make_param_shardings(state.params, mesh,
                                                    run.fsdp))
        new, m = step(placed, batch_on(mesh, batch))
    worst, scale, _ = errors(new.params, plain.params)
    m_err = errors(new.opt.m, plain.opt.m)
    return {"loss": float(m["loss"]), "plain_loss": float(pm["loss"]),
            "aux": float(m["aux"]), "plain_aux": float(pm["aux"]),
            "grad_norm": float(m["grad_norm"]),
            "plain_grad_norm": float(pm["grad_norm"]),
            "param_err": worst, "param_scale": scale,
            "m_err": m_err[0], "m_scale": m_err[1],
            "dp_groups": policy.meta["dp_groups"]}


def check_train_ssd(mesh, inputs):
    """A mamba2-shaped step under the policy (FSDP, grad_shardings)
    against the unsharded step: 3 heads of 32 whose 96 channels the two
    "model" ranks share 48 each (rank 0 a head and a half), four SSD
    chunks a row whose C B^T the two ranks share two each."""
    cfg = dataclasses.replace(small("mamba2-130m"), d_model=48,
                              ssm_head_dim=32)
    run = RunConfig(model=cfg, mode="train", seq_len=16, global_batch=8,
                    remat="dots", fsdp=True)
    state, _ = ts.init_train_state(torch.Generator().manual_seed(9), cfg,
                                   run)
    batch = SyntheticLM(cfg, run, seed=9, device="cpu").batch(0)
    return sharded_step(mesh, cfg, run, state, batch, True)


def check_decode(mesh, inputs):
    cfg = cfg_of("glm4-9b", DENSE)
    run = RunConfig(model=cfg, mode="decode", seq_len=24, global_batch=8)
    params = state_from(inputs, "dense").params
    tokens = SyntheticLM(cfg, run, seed=3, device="cpu").batch(0)["tokens"]
    prompt = tokens[:, :16]
    out = {"err": 0.0, "ids_equal": True, "argmax_equal": True,
           "logits_split": []}
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
                # the greedy pick on the sharded logits (serve_step's)
                out["logits_split"].append(str(got.placements))
                out["argmax_equal"] &= bool(torch.equal(
                    api.whole(api.argmax(got)), want.argmax(-1)))
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


def check_prefill_cache(mesh, inputs):
    """`attention_prefill`'s cache under the policy against the unsharded
    call, for a full cache longer than the prompt, one of its length, a
    windowed ring that wraps and one with fewer slots than the window
    (DENSE: two KV heads split over "model", their slots exchanged;
    CONTEXT: one KV head, whole): the worst error of k and v relative to
    their max, and each rank's local block of k."""
    from repro_torch.models import attention
    out = {}
    for name, fields in (("dense", DENSE), ("context", CONTEXT)):
        cfg = cfg_of("glm4-9b", fields)
        run = RunConfig(model=cfg, mode="prefill", seq_len=16,
                        global_batch=8, fsdp=True)
        params = state_from(inputs, name).params
        mix = {k: v[0] for k, v in params["blocks"]["b0"]["mix"].items()}
        x = torch.randn((8, 16, cfg.d_model),
                        generator=torch.Generator().manual_seed(8))
        pos = torch.arange(16)[None].expand(8, 16)
        for case, clen, window in (("longer", 24, None), ("equal", 16, None),
                                   ("ring", 6, 6), ("short_ring", 4, 8)):
            with torch.no_grad():
                _, want = attention.attention_prefill(
                    mix, x, pos, cfg, clen, window=window,
                    cache_dtype=torch.float32)
                with api.policy_scope(pt.make_policy(mesh, cfg, run)):
                    placed = pt.distribute(params, pt.make_param_shardings(
                        params, mesh, run.fsdp))
                    _, got = attention.attention_prefill(
                        tr._index(placed["blocks"], 0)["b0"]["mix"],
                        pt.distribute(x, pt.batch_sharding(mesh, cfg, run)),
                        pos, cfg, clen, window=window,
                        cache_dtype=torch.float32)
            out[f"{name}_{case}"] = {
                "err": max(_rel(got[k], want[k]) for k in ("k", "v")),
                "local": list(got["k"].to_local().shape),
                "global": list(got["k"].shape),
                "placements": str(got["k"].placements)}
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


def _rel(got, want):
    return float((api.whole(got) - want).abs().max() / want.abs().max())


def _serve(cfg, run, params, mesh, tokens, steps=2):
    """Prefill of `tokens`, then `steps` greedy decode steps, unsharded
    (with the policy's dispatch-group hint) and under the policy: the
    worst relative error of the logits and of the caches."""
    policy = pt.make_policy(mesh, cfg, run)
    s = tokens.shape[1]

    def go(p, toks):
        outs = []
        with torch.no_grad():
            logits, cache = tr.prefill(p, cfg, tokens=toks,
                                       cache_len=s + steps,
                                       cache_dtype=torch.float32)
            outs.append(logits)
            for i in range(steps):
                ids = api.whole(logits).argmax(-1)
                logits, cache = tr.decode_step(p, cache, ids, s + i, cfg)
                outs.append(logits)
        return outs, cache
    with api.policy_scope(api.ShardingPolicy(None, {}, dict(policy.meta))):
        want, want_cache = go(params, tokens)
    with api.policy_scope(policy):
        got, got_cache = go(pt.distribute(params, pt.make_param_shardings(
            params, mesh, run.fsdp)), pt.distribute(
                tokens, pt.batch_sharding(mesh, cfg, run)))
    return {"err": max(_rel(g, w) for g, w in zip(got, want)),
            "cache_err": max(_rel(g, w) for g, w in zip(
                tree_leaves(got_cache), tree_leaves(want_cache))
                if w.abs().max() > 0)}


def check_serving(mesh, inputs):
    """The serving paths repaired for the production mesh, each under its
    policy against its unsharded call: the context-parallel prefill's
    default route (three heads over "model"), the MoE decode with fewer
    dispatch groups than "data" ranks (one group of eight tokens over
    four; capacity factor 1, so slots drop), the SSD decode (3 heads and
    227 in-projection features, neither dividing "model"), and the RG-LRU
    prefill."""
    from repro_torch.models import attention, moe, ssm
    out = {}
    calls = {"flash": 0, "parts": 0, "columns": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    saved = (attention._flash_local, moe._moe_on_parts, ssm._columns_apart)
    attention._flash_local = counted("flash", saved[0])
    moe._moe_on_parts = counted("parts", saved[1])
    ssm._columns_apart = counted("columns", saved[2])
    try:
        cfg = cfg_of("glm4-9b", CONTEXT)
        run = RunConfig(model=cfg, mode="prefill", seq_len=32,
                        global_batch=8, fsdp=True)
        tokens = SyntheticLM(cfg, run, seed=5, device="cpu").batch(0)[
            "tokens"]
        out["cp_prefill"] = _serve(cfg, run, state_from(
            inputs, "context").params, mesh, tokens, steps=0)
        out["cp_prefill"].update(flash_calls=calls["flash"],
                                 layers=cfg.n_layers)

        cfg = cfg_of("phi3.5-moe-42b-a6.6b", dict(MOE, capacity_factor=1.0))
        run = RunConfig(model=cfg, mode="decode", seq_len=24,
                        global_batch=8, fsdp=True)
        params = state_from(inputs, "moe").params
        policy = pt.make_policy(mesh, cfg, run)
        x = torch.randn((8, 1, cfg.d_model),
                        generator=torch.Generator().manual_seed(6))
        ffn = {k: v[0] for k, v in params["blocks"]["b0"]["ffn"].items()}
        with torch.no_grad():
            with api.policy_scope(api.ShardingPolicy(None, {},
                                                     dict(policy.meta))):
                want, want_aux = moe.moe_ffn(ffn, x, cfg)
                dropped = moe.dropped_slots(x, ffn, cfg)
            with api.policy_scope(policy):
                placed = pt.distribute(params, pt.make_param_shardings(
                    params, mesh, run.fsdp))
                got, got_aux = moe.moe_ffn(
                    tr._index(placed["blocks"], 0)["b0"]["ffn"],
                    pt.distribute(x, pt.batch_sharding(mesh, cfg, run)), cfg)
        tokens = SyntheticLM(cfg, run, seed=7, device="cpu").batch(0)[
            "tokens"][:, :1]
        out["moe_decode"] = dict(
            _serve(cfg, run, params, mesh, tokens), ffn_err=_rel(got, want),
            aux_err=abs(float(api.whole(got_aux)) - float(want_aux)),
            aux=float(want_aux), dropped=dropped, parts_calls=calls["parts"])

        cfg = dataclasses.replace(small("mamba2-130m"), d_model=48,
                                  ssm_head_dim=32)
        run = RunConfig(model=cfg, mode="decode", seq_len=16,
                        global_batch=8, fsdp=True)
        params = tr.init_params(torch.Generator().manual_seed(8), cfg)
        tokens = SyntheticLM(cfg, run, seed=9, device="cpu").batch(0)[
            "tokens"][:, :8]
        out["ssd_decode"] = dict(_serve(cfg, run, params, mesh, tokens),
                                 columns_calls=calls["columns"])

        cfg = small("recurrentgemma-2b")
        run = RunConfig(model=cfg, mode="prefill", seq_len=16,
                        global_batch=8, fsdp=True)
        params = tr.init_params(torch.Generator().manual_seed(10), cfg)
        tokens = SyntheticLM(cfg, run, seed=11, device="cpu").batch(0)[
            "tokens"]
        out["rglru_prefill"] = _serve(cfg, run, params, mesh, tokens)
    finally:
        attention._flash_local, moe._moe_on_parts, ssm._columns_apart = \
            saved
    return out


def check_ssd_share(mesh, inputs):
    """A 2-layer mamba2-shaped model (5 heads of 18: 90 channels) on a
    (2, 4) ("data", "model") mesh of the same ranks, where each rank of
    "model" keeps z and x on its channel share (23 a rank, the last 21:
    a short, padded share; the out projection's rows padded alike): a
    prefill of 16 and of 8 tokens (two rows a rank, fewer than the conv
    history's three, so the history spans ranks) and two greedy decode
    steps against the unsharded model, and a differentiated step (FSDP,
    grad_shardings) against the unsharded one."""
    mesh = make_host_mesh(2, 4, device="cpu")
    cfg = dataclasses.replace(small("mamba2-130m"), n_layers=2, d_model=45,
                              ssm_head_dim=18)
    run = RunConfig(model=cfg, mode="train", seq_len=16, global_batch=8,
                    remat="dots", fsdp=True)
    state, _ = ts.init_train_state(torch.Generator().manual_seed(12), cfg,
                                   run)
    tokens = SyntheticLM(cfg, run, seed=13, device="cpu").batch(0)["tokens"]
    out = {f"prefill_{s}": _serve(cfg, run, state.params, mesh,
                                  tokens[:, :s])
           for s in (16, 8)}
    batch = SyntheticLM(cfg, run, seed=14, device="cpu").batch(0)
    out["step"] = sharded_step(mesh, cfg, run, state, batch, True)
    return out


def check_cp_prefill(mesh, inputs):
    """The context-parallel prefill (three heads, one KV head) on a (2,
    4) ("data", "model") mesh of the same ranks: each rank attends its 8
    of 32 queries to the whole keys on the chunked route, with the score
    budget cut so that its chunks are 2 queries (the in-place softmax,
    four chunks a rank), against the unsharded prefill."""
    from repro_torch.models import attention
    mesh = make_host_mesh(2, 4, device="cpu")
    cfg = cfg_of("glm4-9b", CONTEXT)
    run = RunConfig(model=cfg, mode="prefill", seq_len=32, global_batch=8,
                    fsdp=True)
    tokens = SyntheticLM(cfg, run, seed=15, device="cpu").batch(0)["tokens"]
    chunks = []
    saved = attention.SCORE_BYTES, attention._scores_chunk
    # 4 rows x 3 heads x 2 queries x 32 keys x 4 bytes (float32: one copy)
    attention.SCORE_BYTES = 4 * 3 * 2 * 32 * 4

    def recorded(*a):
        chunks.append(saved[1](*a))
        return chunks[-1]
    attention._scores_chunk = recorded
    try:
        out = _serve(cfg, run, state_from(inputs, "context").params, mesh,
                     tokens, steps=0)
    finally:
        attention.SCORE_BYTES, attention._scores_chunk = saved
    out["chunks"] = sorted(set(chunks))
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
                                  ("train_seq", check_train_seq),
                                  ("split_rows", check_split_rows),
                                   ("context_parallel",
                                    check_context_parallel),
                                   ("moe", check_moe),
                                  ("train_moe", check_train_moe),
                                  ("train_ssd", check_train_ssd),
                                   ("decode", check_decode),
                                   ("prefill_cache", check_prefill_cache),
                                   ("families", check_families),
                                   ("serving", check_serving),
                                   ("ssd_share", check_ssd_share),
                                   ("cp_prefill", check_cp_prefill))}
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
