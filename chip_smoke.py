#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `src/repro_torch/kernels/csrc/`,
holds each against its plain PyTorch version on the card, and drives the
port's main path - the paper's program-once / solve-many serving flow -
at full width, checking that it went through the kernels.  Phases (every
check raises; nothing is caught):

  1. the card's name and power limit; TF32 off for matmuls and cuDNN;
  2. build the kernels (one nvcc per source, in parallel);
  3. the arena kernel against its plain version at the main path's
     shapes and three others, with times (CUDA events) and the bound;
  4. the main path: a `SolverService` at the paper's Fig. 8 configuration
     (n=256, stages=2, 64x64 arrays, sigma=0.05) programs 16 Wishart
     tenants, takes 8 right-hand sides each, answers them with one
     `flush_all` (one packed launch) and one single-tenant `flush` (one
     whole-program launch); answers checked against the plain path, and
     an ideal-config solve against a float64 solve;
  5. the per-level path (n=1024, 64x64 arrays, stages=2: mixed tile
     shapes, one launch per level group) against the plain path;
  6. one JSON line describing each ported kernel;
  7. last line: {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores
KERNEL_REL_TOL = 1e-5   # kernel vs plain: reassociated f32 sums
SOLVE_REL_TOL = 1e-4    # end-to-end answers: the same, through 23 cascaded
#                         tiles whose Schur updates cancel
IDEAL_TOL = 1e-4        # ideal config vs float64 solve, paper metric (f32)


def _fail(msg: str):
    raise AssertionError(msg)


def _max_err(out: torch.Tensor, ref: torch.Tensor):
    err = float((out.double() - ref.double()).abs().max())
    scale = float(ref.double().abs().max())
    return err, err / max(scale, 1e-30)


def _check_close(what, out, ref, rel):
    err, relerr = _max_err(out, ref)
    print(f"  {what}: max abs err {err:.3e} ({relerr:.3e} of max|ref|, "
          f"tolerance {rel:g})")
    if not relerr <= rel:
        _fail(f"{what}: {relerr:.3e} > {rel:g} of max|ref|")
    return err


def _check_quantized(what, out, ref, step):
    """Converters on: a reassociated pre-ADC sum may land one step away,
    and the step propagates down the cascade - allow that on at most 2% of
    the elements and never more than 4 steps."""
    err = (out.double() - ref.double()).abs()
    off = float((err > KERNEL_REL_TOL * ref.abs().max()).double().mean())
    print(f"  {what}: max abs err {float(err.max()):.3e} (step {step:.3e}),"
          f" {off:.3%} of elements off")
    if not (float(err.max()) <= 4 * step and off <= 0.02):
        _fail(f"{what}: converter outputs disagree beyond one-step flips")
    return float(err.max())


def _time_ms(fn, reps: int, per_batch: int) -> float:
    """Median device time of one call: batches of back-to-back calls
    between two CUDA events (so host launch overhead overlaps), after a
    warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(per_batch):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / per_batch)
    return statistics.median(times)


def _bound(m, s, k, t, r, c, j):
    """Least time for one call: each input read once, each output written
    once, over HBM; the gathers and products over the f32 peak."""
    nbytes = 4 * (2 * m * s * k + m * t * r * c + 2 * t * j + 2 * t)
    flops = m * t * k * (2 * r * c + 2 * j * c)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _program_meta(blockamc, cfg, n, device):
    """The whole-schedule window program of an (n, stages=2, cfg) plan and
    its arena size."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4 * n, n, generator=gen)
    a = (x.T @ x / (4 * n)).to(device)
    ap = blockamc.ProgrammedSolver.program(a, gen, cfg, 2,
                                           device=device).arena
    return ap.program[1:], ap.arena_size


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)   # progress survives a kill
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import blockamc
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.metrics import relative_error
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.data.matrices import random_rhs, wishart
    from repro_torch.kernels import _build, arena_mvm, ref
    from repro_torch.serve import SolverService

    dev = torch.device("cuda")

    # -- 1. the card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(built)}")
    for name, info in built.items():
        print(f"  {name}: {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {line.strip()}")

    # -- 3. the kernel against its plain version ---------------------------
    print("phase 3: arena kernel vs plain version on the card")
    cfg64 = AnalogConfig(array_size=64)
    meta64 = _program_meta(blockamc, cfg64, 256, dev)
    meta256 = _program_meta(blockamc, AnalogConfig(array_size=256), 1024,
                            dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [("main path", 16, 8, 64, meta64, None),
             ("wide", 128, 128, 64, meta64, None),
             ("256x256 tiles", 4, 32, 256, meta256, None),
             ("ragged K=5, 8-bit converters", 16, 5, 64, meta64, 8)]
    stats = {}
    for label, m, k, rc, (meta, s), bits in cases:
        n_tiles, n_terms = meta[0].shape
        arena0 = torch.rand((m, s, k), generator=gen, device=dev) * 2 - 1
        ops = torch.randn((m, n_tiles, rc, rc), generator=gen, device=dev) \
            * (0.5 / rc ** 0.5)
        kw = dict(dac_bits=bits, adc_bits=bits)
        plain = ref.arena_packed_ref(arena0, ops, *meta, **kw)
        out = arena_mvm.arena_packed_apply(arena0.clone(), ops, *meta, **kw)
        torch.cuda.synchronize()
        what = (f"{label}: M={m} T={n_tiles} R=C={rc} J={n_terms} S={s} "
                f"K={k}")
        if bits is None:
            err = _check_close(what, out, plain, KERNEL_REL_TOL)
        else:
            err = _check_quantized(what, out, plain, 2.0 / (2 ** bits - 1))
        scratch = arena0.clone()
        ms = _time_ms(lambda: arena_mvm.arena_packed_apply(
            scratch, ops, *meta, **kw), reps=7, per_batch=20)
        plain_ms = _time_ms(lambda: ref.arena_packed_ref(
            arena0, ops, *meta, **kw), reps=3, per_batch=2)
        bound_ms, bound_by = _bound(m, s, k, n_tiles, rc, rc, n_terms)
        print(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.2%} of the bound")
        stats[label] = dict(err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)

    # -- 4. the main path: a solver service at Fig. 8's configuration -------
    print("phase 4: SolverService, n=256 stages=2 64x64 sigma=0.05, "
          "16 tenants x 8 rhs")
    n, tenants, k = 256, 16, 8
    cfg = AnalogConfig(array_size=64, nonideal=NonidealConfig(sigma=0.05))
    data = torch.Generator().manual_seed(2024)
    mats = [wishart(data, n, device=dev) for _ in range(tenants)]
    rhs = [[random_rhs(data, n, device=dev) for _ in range(k)]
           for _ in range(tenants)]
    extra = [random_rhs(data, n, device=dev) for _ in range(k)]
    ids = [f"tenant{i}" for i in range(tenants)]

    arena_mvm.arena_packed_apply.launches = 0
    t0 = time.perf_counter()
    svc = SolverService(cfg, stages=2, device=dev)
    for i, mid in enumerate(ids):
        svc.program(mid, mats[i], torch.Generator().manual_seed(i))
    t_prog = time.perf_counter() - t0
    for mid, cols in zip(ids, rhs):
        for b in cols:
            svc.submit(mid, b)
    t0 = time.perf_counter()
    answers = svc.flush_all()
    t_flush_all = time.perf_counter() - t0
    for b in extra:
        svc.submit(ids[0], b)
    t0 = time.perf_counter()
    single = svc.flush(ids[0])
    torch.cuda.synchronize()
    t_flush = time.perf_counter() - t0
    main_launches = arena_mvm.arena_packed_apply.launches
    print(f"  programmed {tenants} tenants in {t_prog:.3f} s; flush_all "
          f"{t_flush_all * 1e3:.3f} ms, flush {t_flush * 1e3:.3f} ms "
          f"(host clock, first call)")
    print(f"  arena kernel launches on the main path: {main_launches} "
          f"(expected 2: one packed, one whole-program)")
    if main_launches != 2:
        _fail(f"main path launched the arena kernel {main_launches} times")
    if sorted(answers) != sorted(ids) or any(
            answers[mid].shape != (n, k) for mid in ids):
        _fail("flush_all answered the wrong tenants or shapes")
    if not all(np.isfinite(answers[mid]).all() for mid in ids):
        _fail("flush_all returned non-finite answers")
    pp = blockamc.pack_arena_plans([svc.solver(mid).arena for mid in ids])
    bs = torch.stack([torch.stack(cols, dim=1) for cols in rhs])
    plain = blockamc.execute_arena_packed(pp, bs, use_kernel=False)
    got = torch.from_numpy(np.stack([answers[mid] for mid in ids]))
    _check_close("flush_all vs plain path", got, plain.cpu(), SOLVE_REL_TOL)
    plain1 = blockamc.execute_arena(svc.solver(ids[0]).arena,
                                    torch.stack(extra, dim=1),
                                    use_kernel=False)
    _check_close("single-tenant flush vs plain path", single, plain1,
                 SOLVE_REL_TOL)
    ideal = blockamc.ProgrammedSolver.program(
        mats[1], torch.Generator(), AnalogConfig(array_size=64), 2,
        device=dev)
    x = ideal.solve_many(bs[1])
    x64 = torch.linalg.solve(mats[1].double(), bs[1].double())
    err = float(relative_error(x64.T, x.double().T).max())
    print(f"  ideal config vs float64 solve: paper metric {err:.3e} "
          f"(tolerance {IDEAL_TOL:g})")
    if not err < IDEAL_TOL:
        _fail(f"ideal solve error {err:.3e} >= {IDEAL_TOL:g}")
    flush_ms = []
    for _ in range(5):                   # steady state: the pack is cached
        for mid, cols in zip(ids, rhs):
            for b in cols:
                svc.submit(mid, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.flush_all()
        flush_ms.append((time.perf_counter() - t0) * 1e3)
    steady_ms = statistics.median(flush_ms)
    print(f"  steady flush_all (16 x 8 rhs, host clock, median of 5): "
          f"{steady_ms:.3f} ms, of which the kernel "
          f"{stats['main path']['ms']:.3f} ms (phase 3) = "
          f"{stats['main path']['ms'] / steady_ms:.1%}")

    # -- 5. the per-level path ----------------------------------------------
    print("phase 5: ProgrammedSolver.solve_many, n=1024 stages=2 64x64 "
          "(mixed tile shapes: per-level launches)")
    big = blockamc.ProgrammedSolver.program(
        wishart(data, 1024, device=dev), torch.Generator().manual_seed(7),
        cfg, 2, device=dev)
    ap = big.arena
    if not (ap.kernel_ok and ap.program is None):
        _fail("n=1024 plan should be whole-window without a uniform program")
    groups = sum(len({tile[0] for tile in level}) for level in ap.levels)
    b_big = torch.stack([random_rhs(data, 1024, device=dev)
                         for _ in range(k)], dim=1)
    arena_mvm.arena_packed_apply.launches = 0
    xs = big.solve_many(b_big)
    torch.cuda.synchronize()
    level_launches = arena_mvm.arena_packed_apply.launches
    print(f"  {len(ap.levels)} levels, {groups} level groups, "
          f"{level_launches} launches")
    if level_launches != groups:
        _fail(f"per-level path launched {level_launches} times, expected "
              f"{groups}")
    _check_close("per-level kernel path vs plain path", xs,
                 blockamc.execute_arena(ap, b_big, use_kernel=False),
                 SOLVE_REL_TOL)

    # -- 6. the kernels line ----------------------------------------------
    main = stats["main path"]
    kernels = [{
        "name": "arena_packed_apply",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/arena_mvm.cu",
        "replaces": "src/repro/kernels/arena_mvm.py:142",
        "launches": main_launches,
        "max_abs_err": main["err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "launches_by_path": {"main path (flush_all + flush)": main_launches,
                             "per-level (n=1024)": level_launches},
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
