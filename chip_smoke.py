#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `src/repro_torch/kernels/csrc/`,
holds each against its plain PyTorch version on the card, and drives the
port's paths at full width, checking that they went through the kernels:
the paper's program-once / solve-many serving flow, and the Fig. 9
interconnect study under the exact nodal wire model.  Phases (every
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
  6. the block-Thomas kernel of the nodal wire model against its plain
     version on real factor stacks: the solver path's shapes (s=64), one
     readout chunk of Fig. 9's original AMC (s=256) and float64;
  7. the paper's Fig. 9 Monte-Carlo (n=256 Wishart, 40 simulations,
     sigma=0.05, 1 ohm wires, nodal model): `solve_batched` two-stage
     64x64, `solve_original_batched` (one 256x256 array), one-stage 128x128
     with nodal write-verify; each column's readouts against float64 on
     the same conductances, and (but the original AMC's) its answers
     against the plain path, write-verify included; the first-order
     model's medians beside;
  8. serving with the nodal model: a `SolverService` (n=256, stages=2,
     64x64, nodal write-verify, stuck-at faults) programs 4 tenants and
     answers 8 rhs each with one `flush_all`; answers against the plain
     path, programming included;
  then one JSON line describing each ported kernel, and the last line:
  {"ok": true, "device": {...}}.

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
F64_FLOP_PER_S = 67e12         # H100 SXM data sheet, FP64 Tensor Core (the
#                                sweeps are matrix products)
KERNEL_REL_TOL = 1e-5   # kernel vs plain: reassociated f32 sums
SOLVE_REL_TOL = 1e-4    # end-to-end answers: the same, through 23 cascaded
#                         tiles whose Schur updates cancel
IDEAL_TOL = 1e-4        # ideal config vs float64 solve, paper metric (f32)
KERNEL_F64_TOL = 1e-12  # block-Thomas kernel vs plain in float64
FIG9_SIMS = 40          # the paper's "40 random simulations" (Section IV)


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


def _banded_bound(b, nr, s, k, dtype):
    """Least time of one block-Thomas call: minv, rhs read once and out
    written once over HBM; 4*nr*s^2*k flops a batch element over the
    dtype's peak."""
    size = 8 if dtype == torch.float64 else 4
    nbytes = size * b * nr * s * (s + 2 * k)
    flops = 4 * b * nr * s * s * k
    peak = F64_FLOP_PER_S if dtype == torch.float64 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _banded_phase(dev):
    """Phase 6: the block-Thomas kernel against its plain version.

    Two inputs at each shape.  Well-conditioned random factor stacks hold
    the kernel to its plain version at KERNEL_REL_TOL (f32) or
    KERNEL_F64_TOL (f64).  The factor stacks and residual rhs of real
    crossbars (identity drive, as every nodal readout has it: k = s) are
    where it is timed; their recursion amplifies rounding (gw * Minv_i is
    O(1) over nr steps), so any two float32 summation orders differ there
    by far more than 1e-5 of max|out|: in float32 the kernel is held to
    the float64 evaluation of the same sweeps, its error within 4 times
    the plain float32 version's own (or KERNEL_REL_TOL, if larger)."""
    from repro_torch.kernels import banded_solve, ref
    from repro_torch.physics import nodal
    print("phase 6: block-Thomas kernel vs plain version on the card")
    gen = torch.Generator(device=dev).manual_seed(6)
    gw = 1.0                                   # 1 ohm wire segments
    cases = [("solver path", 4, 64, torch.float32),
             ("solver-path INV bucket, both arrays", 8, 64, torch.float32),
             ("single array", 1, 64, torch.float32),
             ("Fig. 9 original-AMC chunk", 8, 256, torch.float32),
             ("float64", 4, 64, torch.float64)]
    stats = {}
    for label, b, s, dtype in cases:
        what = f"{label}: B={b} nr=s=k={s} {str(dtype)[6:]}"
        f64 = dtype == torch.float64
        tol = KERNEL_F64_TOL if f64 else KERNEL_REL_TOL
        # well-conditioned random stacks: kernel vs plain at tol
        m = torch.randn((b, s, s, s), generator=gen, device=dev,
                        dtype=dtype) * (0.5 / s ** 0.5)
        r = torch.randn((b, s, s, s), generator=gen, device=dev, dtype=dtype)
        _check_close(f"{what}, random stacks", banded_solve.
                     block_tridiag_solve(m, r, gw=0.5),
                     ref.block_tridiag_solve_ref(m, r, gw=0.5), tol)
        del m, r
        # real crossbars
        g = torch.rand((b, s, s), generator=gen, device=dev,
                       dtype=dtype) * 100e-6
        eye = torch.eye(s, dtype=dtype, device=dev).expand(b, s, s)
        minvs, rhs, _ = nodal._mvm_prepare(g, eye, gw)
        plain = ref.block_tridiag_solve_ref(minvs, rhs, gw=gw)
        out = banded_solve.block_tridiag_solve(minvs, rhs, gw=gw)
        torch.cuda.synchronize()
        if f64:
            err = _check_close(f"{what}, real crossbars", out, plain, tol)
        else:
            truth = ref.block_tridiag_solve_ref(minvs.double(),
                                                rhs.double(), gw=gw)
            err, rel = _max_err(out, truth)
            _, rel_plain = _max_err(plain, truth)
            limit = max(4 * rel_plain, tol)
            print(f"  {what}, real crossbars, against float64: kernel "
                  f"{rel:.3e}, plain version {rel_plain:.3e} of max|ref| "
                  f"(limit {limit:.3e}); kernel vs plain "
                  f"{_max_err(out, plain)[1]:.3e}")
            if not rel <= limit:
                _fail(f"{what}: kernel error {rel:.3e} > {limit:.3e}")
            del truth
        big = s >= 256
        ms = _time_ms(lambda: banded_solve.block_tridiag_solve(
            minvs, rhs, gw=gw), reps=5 if big else 7,
            per_batch=3 if big else 20)
        plain_ms = _time_ms(lambda: ref.block_tridiag_solve_ref(
            minvs, rhs, gw=gw), reps=3, per_batch=2)
        bound_ms, bound_by = _banded_bound(b, s, s, s, dtype)
        print(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.2%} of the bound")
        stats[label] = dict(err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        del minvs, rhs, plain, out
    # float32 against float64 where it matters: the effective conductance
    # H of two 256 x 256 crossbars, relative to max|H - g| (the IR-drop
    # effect itself)
    g = torch.rand((2, 256, 256), generator=gen, device=dev,
                   dtype=torch.float64) * 100e-6
    h64 = nodal.nodal_effective_conductance_batched(g, 1.0)
    effect = float((h64 - g).abs().max())
    for what, kw in (("kernel", {}), ("plain", {"use_kernel": False})):
        h32 = nodal.nodal_effective_conductance_batched(g.float(), 1.0, **kw)
        rel = float((h32.double() - h64).abs().max()) / effect
        print(f"  float32 H ({what} sweeps) vs float64 at 256 x 256: "
              f"{rel:.3e} of max|H - g| ({effect:.3e} S)")
        stats[f"H float32 vs float64, {what}"] = rel
    return stats


def _readout_errors(fplan, cfg):
    """Every bucket of a programmed plan read out three ways - the kernel,
    the plain sweeps, the plain sweeps in float64 on the same conductances
    - and the float32 readouts' largest error against float64, as a
    fraction of the IR-drop effect max|A_eff - A_ideal| (phase 6's
    measure); returns (kernel, plain)."""
    from repro_torch.core.analog import TileGrid
    rel, rel_plain = 0.0, 0.0
    for grid in fplan.inv_stacks + fplan.mvm_stacks:
        wide = TileGrid(grid.gpos.double(), grid.gneg.double(),
                        grid.scale.double(), grid.g0)
        a64 = wide.a_eff(cfg, use_kernel=False)
        effect = float((a64 - (wide.gpos - wide.gneg) / wide.g0).abs().max())
        for what, kw in (("kernel", {}), ("plain", {"use_kernel": False})):
            err = float((grid.a_eff(cfg, **kw).double() - a64).abs().max())
            if what == "kernel":
                rel = max(rel, err / effect)
            else:
                rel_plain = max(rel_plain, err / effect)
        del wide, a64
    return rel, rel_plain


def _fig9_phase(dev, n=256, sims=FIG9_SIMS):
    """Phase 7: the paper's Fig. 9 columns at n=256 under the nodal model;
    returns the block-Thomas launches of the three entry-point runs.

    Each column runs twice through its entry point, with the kernels and
    with `use_kernel=False` (plain sweeps in write-verify and readouts),
    from the same seeds.  The readouts of the conductances the kernel run
    programmed are held to a float64 readout of them: the kernel's error
    within 4 times the plain sweeps' own (or KERNEL_REL_TOL, if larger),
    as in phase 6 - at s=256 the plain float32 sweeps are the less
    accurate side.  The two runs' answers are held to each other at
    SOLVE_REL_TOL, write-verify's readouts included, where the cascade
    keeps readout rounding small: not for the original AMC, whose noisy
    256 x 256 operator amplifies the float32 readouts' rounding (kernel
    and plain alike) far past it."""
    import dataclasses
    from repro_torch.core import blockamc
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.metrics import relative_error
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.data.matrices import random_rhs, wishart
    from repro_torch.kernels import arena_mvm, banded_solve
    print(f"phase 7: Fig. 9 Monte-Carlo, n={n} Wishart, {sims} simulations,"
          f" sigma=0.05, r_wire=1 ohm, nodal wire model")
    data = torch.Generator().manual_seed(9)
    a = wishart(data, n, device=dev)
    b = random_rhs(data, n, device=dev)
    x_ref = torch.linalg.solve(a.double(), b.double())
    ni = NonidealConfig(sigma=0.05, r_wire=1.0, wire_model="nodal")
    columns = [
        ("two_stage", AnalogConfig(array_size=n // 4, nonideal=ni), 2),
        ("orig", AnalogConfig(array_size=n // 2, nonideal=ni), None),
        ("one_stage_compensated", AnalogConfig(
            array_size=n // 2,
            nonideal=dataclasses.replace(ni, compensate_wire=True)), 1)]

    def gens():     # the same seeds: the same noise draws
        return [torch.Generator().manual_seed(100 + i) for i in range(sims)]

    def run(cfg, stages, **kw):
        if stages is None:
            return blockamc.solve_original_batched(a, b, gens(), cfg, **kw)
        return blockamc.solve_batched(a, b, gens(), cfg, stages=stages,
                                      **kw)

    def programmed(cfg, stages):
        """The conductances the entry point's kernel run programmed."""
        if stages is None:
            plan = blockamc.build_original_plan(a, gens(), cfg)
        else:
            plan = blockamc.program_system(
                blockamc.partition_system(a, cfg, stages), gens(), cfg)
        return blockamc.compile_plan(plan)

    launches = 0
    for name, cfg, stages in columns:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        banded_solve.block_tridiag_solve.launches = 0
        arena_mvm.arena_packed_apply.launches = 0
        t0 = time.perf_counter()
        x = run(cfg, stages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        col_launches = banded_solve.block_tridiag_solve.launches
        launches += col_launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if tuple(x.shape) != (sims, n) or not bool(torch.isfinite(x).all()):
            _fail(f"{name}: answers of shape {tuple(x.shape)}, or not "
                  f"finite")
        if col_launches == 0:
            _fail(f"{name}: the nodal readouts never launched the "
                  f"block-Thomas kernel")
        t0 = time.perf_counter()
        x_plain = run(cfg, stages, use_kernel=False)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        print(f"  {name}: {wall:.3f} s wall (plain readouts {wall_plain:.3f}"
              f" s), {col_launches} block-Thomas launches, "
              f"{arena_mvm.arena_packed_apply.launches} arena launches, "
              f"peak memory {peak:.2f} GiB")
        rel, rel_plain = _readout_errors(programmed(cfg, stages), cfg)
        limit = max(4 * rel_plain, KERNEL_REL_TOL)
        print(f"  {name} readouts against float64 on the same conductances:"
              f" kernel {rel:.3e}, plain {rel_plain:.3e} of max|A_eff - "
              f"A_ideal| (limit {limit:.3e})")
        if not rel <= limit:
            _fail(f"{name}: kernel readout error {rel:.3e} > {limit:.3e}")
        if stages is None:
            print(f"  {name} vs plain path: "
                  f"{_max_err(x, x_plain)[1]:.3e} of max|ref| (not gated)")
        else:
            _check_close(f"{name} vs plain path", x, x_plain, SOLVE_REL_TOL)
        med = float(relative_error(x_ref, x.double()).median())
        fo = dataclasses.replace(cfg, nonideal=dataclasses.replace(
            cfg.nonideal, wire_model="first_order"))
        med_fo = float(relative_error(x_ref, run(fo, stages).double())
                       .median())
        print(f"  {name}: median paper error (Eq. 6) nodal {med:.6f}, "
              f"first-order {med_fo:.6f}, model_gap "
              f"{abs(med_fo - med) / med:.4%}")
    return launches


def _nodal_serving_phase(dev, n=256, tenants=4, k=8):
    """Phase 8: a solver service under the nodal model with write-verify
    and stuck-at faults; returns (block-Thomas launches, arena launches)."""
    from repro_torch.core import blockamc
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.data.matrices import random_rhs, wishart
    from repro_torch.kernels import arena_mvm, banded_solve
    from repro_torch.serve import SolverService
    cfg = AnalogConfig(array_size=n // 4, nonideal=NonidealConfig(
        sigma=0.05, r_wire=1.0, wire_model="nodal", compensate_wire=True,
        p_stuck_on=0.001, p_stuck_off=0.001))
    print(f"phase 8: SolverService under the nodal model, n={n} stages=2 "
          f"{n // 4}x{n // 4}, write-verify, stuck-at 0.1%/0.1%, "
          f"{tenants} tenants x {k} rhs")
    data = torch.Generator().manual_seed(8)
    mats = [wishart(data, n, device=dev) for _ in range(tenants)]
    rhs = [torch.stack([random_rhs(data, n, device=dev) for _ in range(k)],
                       dim=1) for _ in range(tenants)]
    ids = [f"nodal{i}" for i in range(tenants)]
    banded_solve.block_tridiag_solve.launches = 0
    arena_mvm.arena_packed_apply.launches = 0
    svc = SolverService(cfg, stages=2, device=dev)
    prog = []
    for i, mid in enumerate(ids):
        before = banded_solve.block_tridiag_solve.launches
        t0 = time.perf_counter()
        svc.program(mid, mats[i], torch.Generator().manual_seed(i))
        prog.append((time.perf_counter() - t0,
                     banded_solve.block_tridiag_solve.launches - before))
    for mid, bs in zip(ids, rhs):
        for j in range(k):
            svc.submit(mid, bs[:, j])
    t0 = time.perf_counter()
    answers = svc.flush_all()
    torch.cuda.synchronize()
    t_flush = time.perf_counter() - t0
    banded = banded_solve.block_tridiag_solve.launches
    arena = arena_mvm.arena_packed_apply.launches
    for i, (sec, nl) in enumerate(prog):
        print(f"  tenant {i}: programmed in {sec:.3f} s with {nl} "
              f"block-Thomas launches")
    print(f"  flush_all {t_flush * 1e3:.3f} ms (host clock, first call); "
          f"{banded} block-Thomas and {arena} arena launches in the phase "
          f"(expected 1 arena launch)")
    if banded == 0 or arena != 1:
        _fail(f"nodal serving launched {banded} block-Thomas and {arena} "
              f"arena kernels")
    if any(answers[mid].shape != (n, k)
           or not np.isfinite(answers[mid]).all() for mid in ids):
        _fail("nodal flush_all answered the wrong shapes or non-finite")
    # the plain path: the same seeds, plain sweeps in write-verify and
    # readouts, plain arena cascade
    for i, mid in enumerate(ids):
        parts = blockamc.partition_system(mats[i], cfg, 2)
        fplan = blockamc.compile_plan(blockamc.program_system(
            parts, torch.Generator().manual_seed(i), cfg, use_kernel=False))
        ap = blockamc.compile_arena(blockamc.finalize(fplan, cfg,
                                                      use_kernel=False))
        plain = blockamc.execute_arena(ap, rhs[i], use_kernel=False)
        _check_close(f"tenant {i} vs plain path",
                     torch.from_numpy(answers[mid]), plain.cpu(),
                     SOLVE_REL_TOL)
    return banded, arena, prog


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

    # -- 6-8. the nodal wire model ----------------------------------------
    banded_stats = _banded_phase(dev)
    t0 = time.perf_counter()
    fig9_launches = _fig9_phase(dev)
    print(f"  phase 7 took {time.perf_counter() - t0:.1f} s")
    serve_banded, serve_arena, _ = _nodal_serving_phase(dev)

    # -- the kernels line ---------------------------------------------------
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
                             "per-level (n=1024)": level_launches,
                             "nodal serving (flush_all)": serve_arena},
    }]
    solver = banded_stats["solver path"]
    kernels.append({
        "name": "block_tridiag_solve",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/banded_solve.cu",
        "replaces": "src/repro/kernels/banded_solve.py:82",
        "launches": fig9_launches + serve_banded,
        "max_abs_err": solver["err"],
        "ms": solver["ms"],
        "plain_ms": solver["plain_ms"],
        "bound_ms": solver["bound_ms"],
        "bound_by": solver["bound_by"],
        "library_ms": None,
        "launches_by_path": {"Fig. 9 Monte-Carlo (phase 7)": fig9_launches,
                             "nodal serving (phase 8)": serve_banded},
        "shapes": {label: {key: st[key] for key in
                           ("err", "ms", "plain_ms", "bound_ms", "bound_by")}
                   for label, st in banded_stats.items()
                   if isinstance(st, dict)},
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
