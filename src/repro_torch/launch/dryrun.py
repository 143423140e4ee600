"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
world, the counterpart of `repro/launch/dryrun.py`.

The reference fakes 512 XLA devices and lowers and compiles each cell's
step.  PyTorch has no ahead-of-time compile: here each cell's real step
runs eagerly as rank 0 of a "fake" process group of 256 (16x16) or 512
(2x16x16) ranks, on fake tensors (`FakeTensorMode`) shaped as that rank's
local shards.  Nothing is allocated, nothing is launched and no card is
needed: the mesh is built for the card's device type ("cuda") without
touching one.  Per cell this gives:

  * memory: the rank's argument and output bytes (its local shards) and
    the peak of the temporaries its step keeps live at once,
  * FLOPs, HBM bytes and collective bytes per chip, from the op trace
    (`hlo_analysis.OpAnalysis`; `raw_cost_analysis` holds
    `FlopCounterMode`'s own total beside it, which counts an op of a
    DTensor at its global shape),
  * the three roofline terms on the H100's rates and the dominant one,
  * the share of the counted FLOPs that the model needs.

Differences from the reference that the report names (`differences`):
the port's default prefill route on the card is the flash kernel, where
the reference's prefill lowers the chunked attention; DTensor and GSPMD
choose different collectives.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --solver

Reports go to `artifacts/dryrun_torch/`, one JSON file a cell.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, ModelConfig, RunConfig
from repro_torch.launch import hlo_analysis
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import serve_step
from repro_torch.models import transformer as tr
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding import api as shapi
from repro_torch.sharding import partition
from repro_torch.tree import tree_leaves
from repro_torch.train.train_step import init_train_state, make_train_step

# --- NVIDIA H100 SXM5 rates (per GPU) ---
PEAK_FLOPS = 989e12   # dense bf16 tensor-core FLOP/s (H100 SXM5 data sheet)
HBM_BW = 3.35e12      # HBM3 bytes/s (H100 SXM5 data sheet)
# bytes/s a GPU across nodes: one 400 Gb/s NDR InfiniBand port a GPU in a
# DGX H100; a 16-wide mesh axis spans two 8-GPU nodes
LINK_BW = 50e9

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# Run-config presets (memory-budget policy per model size)
# ---------------------------------------------------------------------------

class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: `init_params`
    draws on `gen.device`, so parameters come out as shapes only."""

    @property
    def device(self):
        return torch.device("meta")


def _meta_params(cfg: ModelConfig):
    return tr.init_params(_MetaGenerator(), cfg)


@functools.lru_cache(maxsize=None)
def param_count(cfg: ModelConfig) -> int:
    return sum(x.numel() for x in tree_leaves(_meta_params(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    if cfg.n_experts == 0:
        return param_count(cfg)
    return param_count(dataclasses.replace(cfg, n_experts=cfg.top_k))


def make_run_config(cfg: ModelConfig, shape_key: str) -> RunConfig:
    shape = SHAPES[shape_key]
    n = param_count(cfg)
    if shape["mode"] == "train":
        if n >= 100e9:
            extra = dict(fsdp=True, moments_dtype="bfloat16",
                         microbatch=shape["global_batch"] // 16, remat="full",
                         accum_dtype="bfloat16", seq_shard=True)
        elif n >= 10e9:
            extra = dict(fsdp=True, moments_dtype="float32",
                         microbatch=shape["global_batch"] // 4, remat="full",
                         seq_shard=True)
        elif n >= 5e9:
            extra = dict(fsdp=True, moments_dtype="float32",
                         microbatch=shape["global_batch"] // 8, remat="full")
        elif n >= 2e9:
            extra = dict(fsdp=True, moments_dtype="float32",
                         microbatch=shape["global_batch"] // 4, remat="full")
        else:
            # small models: dots-remat alone saves attention scores at
            # (B_loc, H, S, S) f32 - 41 GB/chip at B=256; microbatch 4x
            extra = dict(fsdp=True, remat="dots",
                         microbatch=shape["global_batch"] // 4)
        return RunConfig(model=cfg, **shape, **extra)
    return RunConfig(model=cfg, **shape, fsdp=True, remat="none")


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shapes and dtypes, never allocated)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, run: RunConfig) -> Dict[str, Any]:
    b, s = run.global_batch, run.seq_len
    meta = torch.device("meta")
    if run.mode in ("train", "prefill"):
        if cfg.frontend == "vit_stub":
            batch = {"embeds": torch.empty((b, s, cfg.d_model),
                                           dtype=torch.bfloat16, device=meta)}
        else:
            batch = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                           device=meta)}
        if run.mode == "train":
            batch["labels"] = torch.empty((b, s), dtype=torch.int32,
                                          device=meta)
        return batch
    # decode: one new token against a seq_len cache
    return {
        "cache": tr.init_cache(b, s, cfg, device=meta),
        "tokens_t": torch.empty((b,), dtype=torch.int32, device=meta),
        "pos": torch.empty((), dtype=torch.int32, device=meta),
    }


def skip_reason(cfg: ModelConfig, shape_key: str) -> Optional[str]:
    if shape_key == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: 500k dense-KV decode excluded by the "
                "shape key (needs sub-quadratic attention); see DESIGN.md")
    return None


# ---------------------------------------------------------------------------
# Cache shardings
# ---------------------------------------------------------------------------

def _axis_prod(mesh, ax) -> int:
    if ax is None:
        return 1
    sizes = partition.mesh_axes(mesh)
    if isinstance(ax, tuple):
        return math.prod(sizes[a] for a in ax)
    return sizes[ax]


def _fix(shape, spec, mesh, lead) -> tuple:
    """`lead` + each axis of `spec` that divides its dim (else None)."""
    out = list(lead)
    for dim, ax in zip(shape, spec):
        out.append(ax if ax is not None and dim % _axis_prod(mesh, ax) == 0
                   else None)
    return tuple(out)


def cache_shardings(cache_shapes, mesh, rules) -> Any:
    """KV leaves: (L?, B, S, KV, hd) -> batch on data, seq on model.
    SSM/LRU states: batch on data only.  A tree of `NamedSharding`s like
    the cache (any leaves with a `.shape`)."""
    batch_spec = rules["act_btd"][0]

    def one(keys, leaf):
        name = keys[-1] if keys else ""
        shape = tuple(leaf.shape)
        lead = (None,) if (len(shape) >= 3 and shape[0] != 0
                           and "blocks" in keys) else ()
        core = shape[len(lead):]
        if name in ("k", "v") and len(core) == 4:
            spec = _fix(core, (batch_spec, "model", None, None), mesh, lead)
        else:
            spec = _fix(core, (batch_spec,) + (None,) * (len(core) - 1),
                        mesh, lead)
        return partition.NamedSharding(mesh, partition.P(*spec))

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        return one(keys, node)
    return walk(cache_shapes, ())


# ---------------------------------------------------------------------------
# The fake world and its tensors
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(size: int):
    """A "fake" process group of `size` ranks in this process (this one
    rank 0; no communication, no card), destroyed on exit.  Raises if a
    group exists already: a stale world would give the wrong mesh."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake world, but a "
                           "process group exists already; destroy it first")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device(device) -> torch.device:
    """The device the fake tensors stand for.  A torch built without CUDA
    cannot run its tensor methods on fake "cuda" tensors (their device
    guard needs CUDA), so there the dry run traces "cpu" ones."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError("this torch is built without CUDA: fake 'cuda' "
                           "tensors cannot run here; trace with "
                           "device='cpu'")
    return dev


def _mesh_for(multi_pod: bool, mesh_shape, device):
    """The production mesh (16x16, or 2x16x16 with `multi_pod`), or a
    ("data", "model") host mesh of `mesh_shape`, on the fake world."""
    if mesh_shape is None:
        return mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                             device=device)
    return mesh_mod.make_host_mesh(*mesh_shape, device=device)


def _mesh_name(multi_pod: bool, mesh_shape) -> str:
    if mesh_shape is not None:
        return "x".join(str(d) for d in mesh_shape)
    return "2x16x16" if multi_pod else "16x16"


def _fake_tree(meta, shardings, device):
    """A tree like `meta` (tensors with shapes and dtypes) of DTensors laid
    out by `shardings`, each holding a fake local shard on `device`.  Call
    under a `FakeTensorMode`."""
    if isinstance(meta, dict):
        return {k: _fake_tree(v, shardings[k], device)
                for k, v in meta.items()}
    if isinstance(meta, tuple) and hasattr(meta, "_fields"):
        return type(meta)(*(_fake_tree(a, b, device)
                            for a, b in zip(meta, shardings)))
    place = shardings.placements
    shape = tuple(meta.shape)
    local = _local_shape(shape, shardings.mesh, place)
    return DTensor.from_local(
        torch.empty(local, dtype=meta.dtype, device=device),
        shardings.mesh, place, run_check=False, shape=torch.Size(shape),
        stride=_contiguous_strides(shape))


def _local_shape(shape, mesh, place) -> tuple:
    """This rank's shard of `shape` under `place`: every rule splits
    evenly (`partition._spec`, `_fix`), so each split dim divides."""
    local = list(shape)
    for j, p in enumerate(place):
        if p.is_shard():
            if local[p.dim] % mesh.size(j):
                raise ValueError(f"{shape} does not split evenly by {place}")
            local[p.dim] //= mesh.size(j)
    return tuple(local)


def _contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for d in reversed(shape):
        strides.append(acc)
        acc *= max(d, 1)
    return tuple(reversed(strides))


def _batch_shardings(batch, mesh, rules):
    return {k: partition.NamedSharding(
        mesh, rules["act_btd"] if x.dim() == 3
        else partition.P(rules["act_btd"][0], None))
        for k, x in batch.items()}


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of the tensors in `tree`."""
    return sum(hlo_analysis.tensor_bytes(x)
               for x in hlo_analysis.tensors(tree))


def _trace(step, args, with_grad: bool):
    """Run step(*args) inside an `OpAnalysis` (and a `FlopCounterMode`):
    (analysis result, FlopCounterMode's total, memory, seconds)."""
    from torch.utils.flop_counter import FlopCounterMode
    acc = hlo_analysis.OpAnalysis()
    arg_bytes = acc.hold(args)
    raw = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    grad = contextlib.nullcontext() if with_grad else torch.no_grad()
    with grad, acc, raw:
        out = step(*args)
    seconds = time.perf_counter() - t0
    memory = {"argument_bytes": arg_bytes, "output_bytes": local_bytes(out),
              "temp_bytes": acc.peak_bytes,
              "peak_bytes": arg_bytes + acc.peak_bytes,
              "generated_code_bytes": None}
    result = acc.result()
    result["calls"] = dict(acc.calls)
    result["peak_live"] = acc.peak_live()
    return result, float(raw.get_total_flops()), memory, seconds


def _roofline(flops: float, nbytes: float, coll_bytes: float):
    terms = {"compute_s": flops / PEAK_FLOPS if flops > 0 else None,
             "memory_s": nbytes / HBM_BW if nbytes > 0 else None,
             "collective_s": coll_bytes / LINK_BW}
    valid = {k: v for k, v in terms.items() if v is not None}
    return terms, (max(valid, key=valid.get) if valid else None)


_COLLECTIVES_DIFFER = ("collectives are DTensor's choice for the port's "
                       "placements; GSPMD chooses the reference's")


# ---------------------------------------------------------------------------
# The dry run itself
# ---------------------------------------------------------------------------

def lower_cell(arch: str, shape_key: str, *, multi_pod: bool = False,
               run_override: Optional[RunConfig] = None,
               mesh_shape: Optional[Tuple[int, int]] = None,
               device="cuda") -> Dict[str, Any]:
    """Trace one cell's step as rank 0 of a fake world on the production
    mesh (or a ("data", "model") mesh of `mesh_shape`): the reference's
    report, per chip (module docstring).  A `run_override` brings its
    own model config.  `device` is the device type
    the fake tensors and the mesh stand for ("cuda": the card's, whose
    route takes the flash kernel; "cpu": the host's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = run_override.model if run_override is not None else \
        get_config(arch)
    reason = skip_reason(cfg, shape_key)
    if reason:
        return {"arch": arch, "shape": shape_key, "skipped": reason}
    run = run_override or make_run_config(cfg, shape_key)
    n_world = math.prod(mesh_shape) if mesh_shape is not None else (
        512 if multi_pod else 256)
    dev = _device(device)
    with fake_world(n_world):
        mesh = _mesh_for(multi_pod, mesh_shape, dev.type)
        n_chips = mesh.size()
        rules = partition.activation_rules(mesh, cfg, run)
        policy = partition.make_policy(mesh, cfg, run)
        t0 = time.perf_counter()
        with FakeTensorMode(), shapi.policy_scope(policy):
            step, args, with_grad = _cell_step(cfg, run, mesh, rules, dev)
            t_lower = time.perf_counter() - t0
            acc, raw_flops, memory, t_compile = _trace(step, args, with_grad)

    flops, nbytes = acc["flops"], acc["bytes"]
    coll_bytes = acc["collective_bytes"]
    terms, dominant = _roofline(flops, nbytes, coll_bytes)
    n_active = active_param_count(cfg)
    if run.mode == "train":
        model_flops = 6.0 * n_active * run.global_batch * run.seq_len
    elif run.mode == "prefill":
        model_flops = 2.0 * n_active * run.global_batch * run.seq_len
    else:
        model_flops = 2.0 * n_active * run.global_batch
    flash = acc["calls"].get("repro_torch.flash_attention", 0)
    differences = [_COLLECTIVES_DIFFER]
    if flash:
        differences.append(f"attention took the flash kernel ({flash} "
                           f"calls); the reference's prefill lowers the "
                           f"chunked attention")
    return {
        "arch": arch, "shape": shape_key,
        "mesh": _mesh_name(multi_pod, mesh_shape),
        "n_chips": n_chips,
        "mode": run.mode,
        "device": dev.type,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "flops_per_chip": flops,
        "bytes_per_chip": nbytes,
        "collective_bytes_per_chip": coll_bytes,
        "collectives": acc["collectives"],
        "bytes_by_op": acc["by_op"],
        "flops_by_op": acc["flops_by_op"],
        "top_instrs": acc["top_instrs"],
        "raw_cost_analysis": {"flops": raw_flops, "bytes": -1.0},
        "hlo_warnings": acc["warnings"][:5],
        "memory": memory,
        "peak_live": acc["peak_live"],
        "roofline": terms,
        "dominant": dominant,
        "model_flops_global": model_flops,
        "n_active_params": n_active,
        "useful_flop_ratio": ((model_flops / n_chips) / flops
                              if flops > 0 else None),
        "flash_calls": flash,
        "differences": differences,
    }


def fake_train_state(cfg: ModelConfig, run: RunConfig, mesh, device):
    """(the train state of `cfg` as fake local shards on `device`, laid out
    by `make_state_shardings`; its shardings; the optimizer).  Call under
    a `FakeTensorMode` on a fake world."""
    opt = AdamW(lr=run.learning_rate,
                moments_dtype=_DTYPES[run.moments_dtype])
    state_meta = init_train_state(_MetaGenerator(), cfg, run, opt)[0]
    state_sh = partition.make_state_shardings(state_meta, mesh, run.fsdp)
    return _fake_tree(state_meta, state_sh, device), state_sh, opt


def _cell_step(cfg: ModelConfig, run: RunConfig, mesh, rules, dev):
    """(step, its fake arguments, whether it differentiates) of a cell:
    the train step with `grad_shardings`, the prefill step, or one decode
    step, each on fake local shards laid out as the reference lays its
    arguments out.  Call under a `FakeTensorMode` and the policy."""
    if run.mode == "train":
        state, state_sh, opt = fake_train_state(cfg, run, mesh, dev)
        batch_meta = input_specs(cfg, run)
        batch = _fake_tree(batch_meta, _batch_shardings(batch_meta, mesh,
                                                        rules), dev)
        step = make_train_step(cfg, run, opt, grad_shardings=state_sh.params)
        return step, (state, batch), True
    params_meta = _meta_params(cfg)
    params_sh = partition.make_param_shardings(params_meta, mesh, fsdp=True)
    params = _fake_tree(params_meta, params_sh, dev)
    if run.mode == "prefill":
        batch_meta = input_specs(cfg, run)
        batch = _fake_tree(batch_meta, _batch_shardings(batch_meta, mesh,
                                                        rules), dev)
        cache_sh = cache_shardings(
            tr.init_cache(run.global_batch, run.seq_len, cfg,
                          device="meta"), mesh, rules)
        fn = serve_step.make_prefill_step(cfg, cache_len=run.seq_len)

        def prefill(p, bt):
            nxt, cache = fn(p, bt)
            return nxt, partition.distribute(cache, cache_sh)
        return prefill, (params, batch), False
    specs = input_specs(cfg, run)
    cache_sh = cache_shardings(specs["cache"], mesh, rules)
    cache = _fake_tree(specs["cache"], cache_sh, dev)
    tokens_t = torch.empty((run.global_batch,), dtype=torch.int32,
                           device=dev)
    pos = torch.full((), run.seq_len - 1, dtype=torch.int32, device=dev)
    fn = serve_step.make_decode_step(cfg)

    def decode(p, c, t, ps):
        return fn(p, c, t, ps, None)
    return decode, (params, cache, tokens_t, pos), False


def lower_solver_cell(*, n: int = 16384, stages: int = 2,
                      multi_pod: bool = False,
                      device="cuda") -> Dict[str, Any]:
    """Dry-run the paper's own technique: the distributed BlockAMC solver
    (plan build + five-step cascade) traced on the production mesh.

    A is a DTensor split over ("data", "model") in contiguous blocks, as
    the reference's `in_shardings` lays it out, and b is whole; the port's
    `solve_distributed` deals A into its cyclic split, runs the Schur
    pre-processing's GEMMs on local blocks, programs and reads out each
    rank's own tiles, and splits the cascade's MVMs over the mesh
    (`core/distributed.py`).
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import distributed
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.nonideal import NonidealConfig

    cfg = AnalogConfig(array_size=256, nonideal=NonidealConfig(sigma=0.05))
    dev = _device(device)
    with fake_world(512 if multi_pod else 256):
        mesh = _mesh_for(multi_pod, None, dev.type)
        n_chips = mesh.size()
        a_sh = partition.NamedSharding(mesh, partition.P("data", "model"))
        t0 = time.perf_counter()
        with FakeTensorMode():
            a = _fake_tree(torch.empty((n, n), dtype=torch.float32,
                                       device="meta"), a_sh, dev)
            b = torch.empty((n,), dtype=torch.float32, device=dev)
            gen = torch.Generator()

            def solve(a, b):
                return distributed.solve_distributed(
                    a, b, gen, cfg, stages=stages, mesh=mesh, device=dev)
            t_lower = time.perf_counter() - t0
            acc, raw_flops, memory, t_compile = _trace(solve, (a, b), False)
    terms, dominant = _roofline(acc["flops"], acc["bytes"],
                                acc["collective_bytes"])
    model_flops = 2.0 / 3.0 * n ** 3 * 2 * 2   # block-inv ~2x one LU(2/3 n^3)
    return {"arch": "blockamc-solver", "shape": f"n{n}_s{stages}",
            "mesh": _mesh_name(multi_pod, None),
            "n_chips": n_chips, "mode": "solve", "device": dev.type,
            "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
            "flops_per_chip": acc["flops"], "bytes_per_chip": acc["bytes"],
            "collective_bytes_per_chip": acc["collective_bytes"],
            "collectives": acc["collectives"], "memory": memory,
            "raw_cost_analysis": {"flops": raw_flops, "bytes": -1.0},
            "roofline": terms,
            "dominant": dominant,
            "model_flops_global": model_flops,
            "useful_flop_ratio": (model_flops / n_chips) / max(acc["flops"],
                                                               1),
            "bytes_by_op": acc["by_op"],
        "flops_by_op": acc["flops_by_op"],
            "top_instrs": acc["top_instrs"],
            "differences": [_COLLECTIVES_DIFFER]}


def cell_path(arch: str, shape_key: str, multi_pod: bool) -> str:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    mesh = "2x16x16" if multi_pod else "16x16"
    return os.path.join(ARTIFACT_DIR, f"{arch}__{shape_key}__{mesh}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--solver", action="store_true",
                    help="dry-run the distributed BlockAMC solver cell")
    ap.add_argument("--device", default="cuda",
                    help="the device type the fake tensors stand for")
    args = ap.parse_args(argv)

    if args.solver:
        result = lower_solver_cell(multi_pod=args.multi_pod,
                                   device=args.device)
        path = cell_path("blockamc-solver", result["shape"], args.multi_pod)
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        print(f"solver cell: dominant={result['dominant']} "
              f"terms={result['roofline']} (trace {result['compile_s']}s)")
        return

    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells.append((args.arch, args.shape))

    for arch, shape in cells:
        path = cell_path(arch, shape, args.multi_pod)
        if os.path.exists(path) and not args.force:
            print(f"[skip-cached] {arch} {shape}")
            continue
        print(f"[dryrun] {arch} {shape} multi_pod={args.multi_pod} ...",
              flush=True)
        try:
            result = lower_cell(arch, shape, multi_pod=args.multi_pod,
                                device=args.device)
        except Exception as e:
            result = {"arch": arch, "shape": shape,
                      "mesh": "2x16x16" if args.multi_pod else "16x16",
                      "error": f"{type(e).__name__}: {e}"}
            print(f"  ERROR: {e}")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        if "roofline" in result:
            print(f"  ok: dominant={result['dominant']} "
                  f"terms={result['roofline']} "
                  f"(trace {result['compile_s']}s)")


if __name__ == "__main__":
    main()
