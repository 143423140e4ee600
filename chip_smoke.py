#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `src/repro_torch/kernels/csrc/`,
holds each against its plain PyTorch version on the card, and drives the
port's paths at full width, checking that they went through the kernels:
the paper's program-once / solve-many serving flow, the Fig. 9
interconnect study under the exact nodal wire model, the kernel bench's
rows, the example's path (`examples/solve_linear_system.py`), the
language-model serving path (glm4-9b prefill and decode), the training
path with the BlockAMC preconditioner (stablelm-1.6b), the Monte-Carlo
mesh (the `*_sharded` solvers on a one-rank NCCL group), the MoE,
RG-LRU and SSD model families, the language model's mesh (DTensor
serving and training on a one-rank NCCL group) and the dry run of
production cells on fake 256- and 512-rank worlds.  Phases (every check
raises; nothing is caught):

  1. the card's name and power limit; TF32 off for matmuls and cuDNN;
  2. build the kernels (one nvcc per source, in parallel), with each
     kernel's registers and spills and the tensor-core kernels' shared
     memory;
  3. the arena kernel against its plain version at the main path's
     shapes and three others, each with the instance it runs (shared-
     memory slice or device-memory arena, column slice, ring slots),
     its time back to back and replayed from a CUDA graph (CUDA events)
     and the bound, and at the main path the chain of dependent tiles:
     the first tile alone (launch, prologue, epilogue) and each further
     tile;
  4. the main path: a `SolverService` at the paper's Fig. 8 configuration
     (n=256, stages=2, 64x64 arrays, sigma=0.05) programs 16 Wishart
     tenants, takes 8 right-hand sides each, answers them with one
     `flush_all` (one packed launch) and one single-tenant `flush` (one
     whole-program launch); answers checked against the plain path, and
     an ideal-config solve against a float64 solve;
  5. the per-level path (n=1024, 64x64 arrays, stages=2: mixed tile
     shapes, one launch per level group) against the plain path, and
     its steady time on the host clock;
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
  9. the kernel bench's rows: the crossbar kernel at (B, R, C) =
     (256, 512, 512) and (512, 1024, 1024), 8-bit and ideal; the stacked
     crossbar at (L, B, R, C) = (16, 64, 64, 64), (16, 128, 128, 128) and
     on one INV bucket stack of the Fig. 8 plan; the Schur kernel at
     n=512 and 1024 (float32) and 128 (bfloat16) - each timed through
     `kernels.ops` and held against its plain version (Schur also timed
     against `torch.addmm`, with the ratio of the two; each row's host
     cost a call printed);
 10. the example's path: the tile solver at n=1024 (stages=3, 128x128,
     sigma 0 / 0.01 / 0.05) against float64, a programmed 256x256
     two-stage solver with 16 rhs and its refined solve, the hybrid
     benchmark's headline preconditioned CG and GMRES (n=64, cond 1e4,
     one arena launch per preconditioner application), the example's
     crossbar check on a mapped tile grid (one launch), the Fig. 8
     service's `solve_refined` and `flush(refined=True)`, and the
     area/energy verdict;
 11. the attention kernel against its plain version at (BH, S, D) =
     (128, 1024, 128) bf16 and f32 (phase 12's prefill and its float32
     route check), (32, 8192, 128) bf16, (8, 1000, 64) f32 (ragged) and
     (16, 1024, 128) f32 non-causal, timed
     beside the plain version and `scaled_dot_product_attention`, with the
     ratio of the kernel's time to the latter's; the kernel's op
     (`torch.ops.repro_torch.flash_attention`) bit for bit against the
     launch alone, and the host's microseconds a call through each;
 12. the language-model serving path at glm4-9b's full width and depth
     (bf16, random weights from a seeded CUDA generator):
     `Engine.generate` of 32 greedy tokens after a (4, 1024) prompt (40
     flash launches, one a layer of the prefill; deterministic), a
     `ContinuousBatchingEngine` serving 6 requests over 4 slots, the two
     attention routes compared in bf16 (information) and, in a 2-layer
     float32 glm4-9b, the prefill logits through the kernel against the
     chunked path (2e-4 of max|logit|); one (4, 1024) prefill under
     `FlopCounterMode` with its peak memory, for phase 19;
 13. the maintained serving path: Fig. 8's service (16 tenants x 8 rhs)
     with retention drift (drift_nu 0.05) through three waves of the
     maintenance cycle on a `DeviceClock` - age every plan
     (`ProgrammedSolver.aged` at per-array `PlanAges`) and `refresh`;
     scrub, repair the pending arrays (`repaired`) and `refresh`;
     `flush_all`, one packed launch held to the plain path - with an aged
     solver against a finalize at its ages and a spliced arena against a
     fresh compile; d sum(w x)/db through the kernel path (one launch in
     the forward) against the plain path, single and packed; a block
     repair timed against a full re-program (n=256, 128x128 arrays,
     write-verify, 1/8 of the arrays); `calibrate_wire` at n=16, 120
     steps, recovering a planted 1 ohm from the nodal oracle to 5%;
 14. the async serving engine and the replicated fleet at Fig. 8's
     configuration (16 tenants, `router_bench.py`'s open-loop Poisson
     trace: 480 arrivals at 400 Hz, deadline 0.25 s): the fleet with 1 and
     3 replicas on the card (replicated programming checked bit for bit),
     r0's worker killed mid-traffic with the replacement restoring from a
     `ProgramStore` or, its checkpoints value-corrupted, re-programming
     (recovery times and their ratio), and `engine_bench.py`'s faulted
     run on one engine (a dispatch exception, a stuck-at fault on one
     tenant); every answer within 1e-4 of max|x| of its plan's plain
     path, no deadline miss outside the replays and the faulted tenant,
     at least one arena launch a dispatch; p50/p99 and goodput printed;
 15. the training path (stablelm-1.6b at full width and depth, bf16,
     random weights from a CUDA generator seeded 0): `Trainer.run` of 4
     steps of (8, 4096) tokens (train_4k's sequence, its batch cut from
     256 to 8, microbatches of 2, remat "dots"): finite losses, no
     attention-kernel launch, step wall, tokens/s, peak memory, the
     card's busy share of a step and the step's bound; `BlockAMCPrecond`
     on the embedding's gradient at the reference's defaults - the
     digital refresh (28 `block_inv` of 2048) against a float64 inverse
     root, the analog refresh (28 programs, one arena launch each)
     against the digital one within 0.05; a 2-layer float32 stablelm at
     full width, gradients and one `make_train_step` on the card against
     the host (1e-4 of max|g|, loss 1e-5), remat "dots" / "full" against
     "none" (1e-6); a trainer saved at step 2 and resumed on the card at
     host scale reproduces the uninterrupted losses (1e-6); one more step
     under `FlopCounterMode` (out of the median), for phase 19;
 16. the Monte-Carlo mesh on a one-rank NCCL group (`make_mc_mesh`):
     Fig. 7's sweep at its largest size (n=512, one stage, 256x256
     arrays, sigma 0.05, 40 simulations) through
     `solve_batched_sharded(mode="fused")`, one arena launch, against
     `solve_batched` on the same generators; Fig. 8's packed fleet (16
     tenants x 8 rhs) through `execute_arena_packed_sharded`, one launch,
     against `execute_arena_packed`; `solve_refined_batched_sharded` on 8
     keys at n=256 (float64 GMRES), every column converged, against
     `solve_refined_batched`; the group destroyed after;
 17. the MoE, RG-LRU and SSD families, seeded random bf16 weights, each
     model freed before the next: recurrentgemma-2b at full size serving
     a (2, 3072) prompt (past its 2048-token window) and 32 greedy tokens
     with no flash launch; mamba2-130m at full size serving phase 12's
     traffic, training 4 steps of (8, 4096) tokens (microbatches of 2,
     remat "dots") and, at 2 layers in float32, its loss and gradients
     card against host (1e-5, 1e-4 of max|g|); phi3.5-moe at full width
     and 16 of its 32 layers (the 32 do not fit 80 GB) serving phase 12's
     traffic with one flash launch a layer of the prefill, the capacity
     drops counted, and a 2-layer float32 route check (2e-4 of
     max|logit|); prefill wall, decode ms a step, peak memory and busy
     share of each;
 18. the language model's mesh on a one-rank NCCL group
     (`make_host_mesh(1, 1)`), every tensor a DTensor: glm4-9b at full
     size under `make_policy` (phase 12's prompt, 40 flash launches on
     the local heads, logits 2e-4 of max|logit| from the unsharded
     prefill, 8 greedy steps with the same ids, walls and busy shares
     beside phase 12's); stablelm-1.6b at 4 of its 24 layers, 2
     sharded steps (`make_state_shardings`, `batch_sharding`,
     `grad_shardings`) against the unsharded step (loss 1e-5 relative,
     parameters 1e-4 of max|p|, no flash launch); `compressed_psum` over
     a one-rank "pod" axis; the state saved sharded and restored with
     `sharding_tree` bit for bit; `pipeline_apply` on a one-rank "pp"
     axis against the stack;
 19. the dry run (`launch/dryrun.py`) on the card's host, each cell
     traced as rank 0 of a fake world on fake tensors in a process of
     its own, in parallel: stablelm-1.6b train_4k, glm4-9b prefill_32k
     (40 calls of the attention op's fake implementation) and
     mamba2-130m decode_32k on 16x16 (256 ranks) and 2x16x16 (512), the
     BlockAMC solver at n=2048, one stage - each with its dominant
     roofline term, the three terms, FLOPs, bytes, collective bytes a
     chip, peak and seconds; and one-rank traces of phase 15's step and
     phase 12's prefill against the card: FLOPs equal to
     `FlopCounterMode`'s to 1e-6, peak within 15%, each measured wall at
     least its compute term;
  then one JSON line describing each ported kernel, and the last line:
  {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
from functools import partial
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM data sheet, dense bf16 tensor cores
TF32_FLOP_PER_S = 495e12       # H100 SXM data sheet, dense tf32 tensor cores
F64_FLOP_PER_S = 67e12         # H100 SXM data sheet, FP64 Tensor Core (the
#                                sweeps are matrix products)
KERNEL_REL_TOL = 1e-5   # kernel vs plain: reassociated f32 sums
SOLVE_REL_TOL = 1e-4    # end-to-end answers: the same, through 23 cascaded
#                         tiles whose Schur updates cancel
IDEAL_TOL = 1e-4        # ideal config vs float64 solve, paper metric (f32)
KERNEL_F64_TOL = 1e-12  # block-Thomas kernel vs plain in float64
DIST_IDEAL_TOL = 1e-5   # ideal tile solver vs float64, paper metric: f32
#                         through three stages of Schur complements, cond ~9
REFINED_TOL = 1e-4      # refined answers vs float64, paper metric: a 1e-6
#                         relative residual times cond ~9, with f32 residuals
FIG9_SIMS = 40          # the paper's "40 random simulations" (Section IV)
BF16_ROUNDING = 2.0 ** -8  # bf16 attention kernel vs its plain version in
#                            f32 on the same inputs, element by element:
#                            one round-to-nearest of the output to bf16
#                            (at most 2^-8 of |out|) on top of the f32 rule
#                            KERNEL_REL_TOL of max|out|
LM_ROUTE_TOL = 2e-4     # prefill logits, flash kernel vs chunked route, f32:
#                         the reference's in-model tolerance


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


def _check_bf16_rounding(what, out, ref):
    """A bf16 output against a float32 reference, element by element:
    |out - ref| <= BF16_ROUNDING * |ref| + KERNEL_REL_TOL * max|ref|, so
    that rows of small outputs are held to their own size, not to the
    largest row's.  Returns (max abs err, largest ratio err / limit)."""
    err = (out.double() - ref.double()).abs()
    limit = (BF16_ROUNDING * ref.double().abs()
             + KERNEL_REL_TOL * float(ref.double().abs().max()))
    ratio = float((err / limit).max())
    _, relerr = _max_err(out, ref)
    print(f"  {what}: max abs err {float(err.max()):.3e} ({relerr:.3e} of "
          f"max|ref|); largest err / (2^-8 |ref| + {KERNEL_REL_TOL:g} "
          f"max|ref|) = {ratio:.4f} (limit 1)")
    if not ratio <= 1.0:
        _fail(f"{what}: an element is {ratio:.4f} of its bf16 limit")
    return float(err.max()), ratio


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


def _graph_ms(fn, reps: int = 5, per_graph: int = 20) -> float:
    """Median device time of one call, replayed from a CUDA graph of
    `per_graph` captured calls: the host's launch cost (Python, ctypes,
    the wrappers' checks) is left out, which back-to-back timing cannot
    do for calls shorter than it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up off the capture stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / per_graph)
    return statistics.median(times)


def _roofline(nbytes, flops, peak):
    """(least ms, what bounds it): bytes over HBM against flops over the
    peak."""
    return _roofline_s(nbytes, flops / peak)


def _f32_product_s(flops, dac_bits=None):
    """Least seconds for a float32 product of `flops` (2 a multiply-add)
    whose one operand is a DAC's output: the card's fastest route to the
    float32 result.  Codes of at most 9 bits (|q| <= 256) are exact in
    bf16 and a float32 G is exactly three bf16 parts, so three bf16
    products (each exact in f32) at 989 TFLOP/s; codes of 10-12 bits are
    exact in tf32, so two tf32 products (G_hi + G_lo) at 495 TFLOP/s;
    otherwise 3xTF32, three tf32 products."""
    if dac_bits and dac_bits <= 9:
        return 3 * flops / BF16_FLOP_PER_S
    if dac_bits and dac_bits <= 12:
        return 2 * flops / TF32_FLOP_PER_S
    return 3 * flops / TF32_FLOP_PER_S


def _roofline_s(nbytes, op_s):
    """(least ms, what bounds it): bytes over HBM against `op_s` seconds
    of operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, op_s) * 1e3,
            "bytes" if t_bytes >= op_s else "operations")


def _bound(m, s, k, t, r, c, j, dac_bits=None):
    """Least time for one call: each input read once, each output written
    once, over HBM; against the operations: the products at the card's
    fastest route to float32 (`_f32_product_s`; the DAC's output is one
    operand) and the window sums' adds on the CUDA cores, which can run
    beside them, whichever takes longer."""
    return _roofline_s(
        4 * (2 * m * s * k + m * t * r * c + 2 * t * j + 2 * t),
        max(_f32_product_s(2 * m * t * k * r * c, dac_bits),
            2 * m * t * k * j * c / F32_FLOP_PER_S))


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
    written once over HBM; 4*nr*s^2*k flops a batch element at the card's
    rate for the dtype's function - float64 on the FP64 tensor cores,
    float32 as 3xTF32 on the tf32 tensor cores (three products each, the
    card's fastest route to float32 accuracy; the kernel's own)."""
    f64 = dtype == torch.float64
    flops = 4 * b * nr * s * s * k
    return _roofline((8 if f64 else 4) * b * nr * s * (s + 2 * k),
                     flops if f64 else 3 * flops,
                     F64_FLOP_PER_S if f64 else TF32_FLOP_PER_S)


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


MNA_SIZES = (16, 32, 64)   # phase 20: n x n crossbars, the dense system
#                            2 n^2 nodes (8192 at n=64; the INV one 8256)
MNA_RTOL = 1e-6          # the nodal route vs the dense MNA oracle, element
#                          by element: the reference's acceptance bound
#                          (tests/test_physics_oracle.py:65)
MNA_G0 = 100e-6          # the paper's G0 (Section IV)


def _mna_phase(dev, smi):
    """Phase 20: the block-Thomas kernel's double instance against the
    dense float64 MNA oracle on the card.  For n in MNA_SIZES, |Wishart|
    conductances scaled to G0 and a drive |rhs| + 0.1 from a seed (as the
    reference's `tests/test_nonideal.py` builds them), at 1 ohm wire
    segments: `nonideal.mna_mvm_currents` and `mna_inv_outputs` (and the
    effective conductance H, the currents of an identity drive) solved
    densely in float64 on the card (`torch.linalg.solve`), and
    `physics.nodal`'s `nodal_mvm_currents`, `nodal_inv_outputs` and
    `nodal_effective_conductance` with `use_kernel=True` in float64,
    each held to the oracle at MNA_RTOL element by element.  Prints the
    dense solve's and the nodal route's times (CUDA-synchronised host
    clock, the second call) and the kernel's launches.  Returns (the
    launches, the stats)."""
    from repro_torch.core import nonideal
    from repro_torch.data.matrices import random_rhs, wishart
    from repro_torch.kernels import banded_solve
    from repro_torch.physics import nodal
    print(f"phase 20: nodal kernel (float64) vs the dense MNA oracle on the "
          f"card ({smi})")
    f64 = torch.float64

    def timed(fn):
        out = fn()                                 # the first call warms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    stats, launches = {}, 0
    for n in MNA_SIZES:
        gen = torch.Generator().manual_seed(2000 + n)
        a = wishart(gen, n, dtype=f64, device=dev).abs()
        g = a / a.max() * MNA_G0
        v = random_rhs(gen, n, dtype=f64, device=dev).abs() + 0.1
        eye = torch.eye(n, dtype=f64, device=dev)
        (i_ref, u_ref, h_ref), dense_ms = timed(lambda: (
            nonideal.mna_mvm_currents(g, v, 1.0),
            nonideal.mna_inv_outputs(g, v, 1.0, MNA_G0),
            nonideal.mna_mvm_currents(g, eye, 1.0)))
        banded_solve.block_tridiag_solve.launches = 0
        (i, u, h), nodal_ms = timed(lambda: (
            nodal.nodal_mvm_currents(g, v, 1.0, use_kernel=True),
            nodal.nodal_inv_outputs(g, v, 1.0, MNA_G0, use_kernel=True),
            nodal.nodal_effective_conductance(g, 1.0, use_kernel=True)))
        count = banded_solve.block_tridiag_solve.launches
        launches += count
        row = {"dense_ms": dense_ms, "nodal_ms": nodal_ms,
               "launches": count}
        for what, got, want in (("MVM currents", i, i_ref),
                                ("INV outputs", u, u_ref),
                                ("effective conductance", h, h_ref)):
            if not (got.device.type == want.device.type == "cuda"
                    and got.dtype == want.dtype == f64):
                _fail(f"phase 20 n={n} {what}: not float64 on the card")
            rel = float(((got - want).abs() / want.abs()).max())
            row[what] = rel
            if not rel <= MNA_RTOL:
                _fail(f"phase 20 n={n}: the nodal route's {what} are "
                      f"{rel:.3e} off the dense oracle (rtol {MNA_RTOL:g})")
        print(f"  n={n}: dense MNA ({2 * n * n} nodes) {dense_ms:.2f} ms, "
              f"nodal route {nodal_ms:.2f} ms ({count} block-Thomas "
              f"launches, the two calls); largest relative error: MVM "
              f"{row['MVM currents']:.2e}, INV {row['INV outputs']:.2e}, "
              f"H {row['effective conductance']:.2e} (rtol {MNA_RTOL:g})")
        if count == 0:
            _fail(f"phase 20 n={n}: the nodal route launched no kernel")
        stats[f"n={n}"] = row
        del a, g, v, eye, i_ref, u_ref, h_ref
        torch.cuda.empty_cache()
    return launches, stats


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


def _host_ms(fn, reps=3, warmup=1):
    """Median host-clock ms of `fn()` to a synchronised card."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _maintenance_phase(dev, smi, n=256, tenants=16, k=8, waves=3, dt=0.6):
    """Phase 13: the maintained serving path - Fig. 8's service with
    retention drift, driven through the maintenance cycle as the
    reference's async engine drives it (`_maintenance_cycle` /
    `_do_repairs`), synchronously; the gradient through the kernel path;
    the cost of a block repair against a full re-program; wire
    calibration on the nodal oracle.  Returns its launch counts by path."""
    from repro_torch.calib import calibrate_wire
    from repro_torch.core import blockamc
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.data.matrices import random_rhs, wishart
    from repro_torch.kernels import arena_mvm, banded_solve
    from repro_torch.serve import (DeviceClock, MaintenanceConfig,
                                   MatrixMaintenance, SolverService)
    # benchmarks/maint_bench.py: drift_nu 0.05, block_trip 0.02, dt 0.6;
    # four repairs a cycle, so the arrays' ages part ways
    cfg = AnalogConfig(array_size=64, nonideal=NonidealConfig(
        sigma=0.05, drift_nu=0.05))
    mcfg = MaintenanceConfig(scrub_blocks_per_cycle=16, block_trip=0.02,
                             repair_batch=4)
    print(f"phase 13: maintained serving, n={n} stages=2 64x64 sigma=0.05 "
          f"drift_nu=0.05, {tenants} tenants x {k} rhs, {waves} waves of "
          f"{dt} s; card: {smi}")
    data = torch.Generator().manual_seed(13)
    mats = [wishart(data, n, device=dev) for _ in range(tenants)]
    rhs = torch.stack([torch.stack([random_rhs(data, n, device=dev)
                                    for _ in range(k)], dim=1)
                       for _ in range(tenants)])
    ids = [f"aging{i}" for i in range(tenants)]
    svc = SolverService(cfg, stages=2, device=dev)
    for i, mid in enumerate(ids):
        svc.program(mid, mats[i], torch.Generator().manual_seed(1300 + i))
    clock = DeviceClock()
    maint = {mid: MatrixMaintenance(svc.solver(mid), mcfg, clock.now())
             for mid in ids}
    flush_launches = probes = repaired = 0
    t_cycle = []
    for wave in range(waves):
        t = clock.advance(dt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, mid in enumerate(ids):
            m = maint[mid]
            s = svc.solver(mid)                    # 1-2: age, refresh
            ages = m.plan_ages(s.flat, t)
            aged = s.aged(ages)
            svc.refresh(mid, aged)
            m.synced_at = t
            probes += m.scrub(aged.flat, aged.cfg, t,     # 3: scrub,
                              mcfg.scrub_blocks_per_cycle)  # repair
            if not m.pending:
                continue
            blocks = sorted(m.pending)[:mcfg.repair_batch]
            m.repair_rounds += 1
            rep = aged.repaired(blocks, torch.Generator().manual_seed(
                20_000 + 100 * i + m.repair_rounds))
            svc.refresh(mid, rep)
            m.note_repaired(blocks, rep.flat, rep.cfg, t)
            repaired += len(blocks)
            if i == 0:
                # the aged solver is a fresh finalize at the same ages;
                # the spliced arena a fresh compile of the spliced plan at
                # the ages it now holds (the repaired arrays fresh)
                fin = blockamc.finalize(aged.flat, cfg, drift_t=ages)
                _check_close(f"wave {wave}: aged solver vs finalize at its "
                             f"ages (plain executor)",
                             aged.solve_many(rhs[0]),
                             blockamc.execute_finalized(fin, rhs[0]),
                             SOLVE_REL_TOL)
                fresh = blockamc.compile_arena(blockamc.finalize(
                    rep.flat, cfg, drift_t=m.plan_ages(rep.flat, t)))
                _check_close(f"wave {wave}: spliced arena program vs "
                             f"compile_arena(finalize(spliced flat))",
                             rep.arena.program[0], fresh.program[0],
                             KERNEL_REL_TOL)
        torch.cuda.synchronize()
        t_cycle.append(time.perf_counter() - t0)
        for mid, bs in zip(ids, rhs):              # 4: flush
            for j in range(k):
                svc.submit(mid, bs[:, j])
        arena_mvm.arena_packed_apply.launches = 0
        answers = svc.flush_all()
        launched = arena_mvm.arena_packed_apply.launches
        flush_launches += launched
        if launched != 1:
            _fail(f"wave {wave}: flush_all launched {launched} times")
        pp = blockamc.pack_arena_plans([svc.solver(mid).arena for mid in ids])
        _check_close(f"wave {wave}: flush_all (1 launch) vs plain path",
                     torch.from_numpy(np.stack([answers[mid] for mid in ids])),
                     blockamc.execute_arena_packed(pp, rhs,
                                                   use_kernel=False).cpu(),
                     SOLVE_REL_TOL)
        worst = max(m.gauges(t)["worst_dev"] for m in maint.values())
        print(f"  wave {wave} at t={t:.1f} s: maintenance cycle "
              f"{t_cycle[-1]:.3f} s (host clock), worst probe deviation "
              f"{worst:.4f}, {sum(len(m.pending) for m in maint.values())} "
              f"repairs pending")
    print(f"  {probes} probes, {repaired} arrays repaired over {waves} "
          f"waves; {flush_launches} arena launches in {waves} flush_all")
    if repaired == 0:
        _fail("the drift scheduled no repair")

    # the gradient through the kernel path (one launch in the forward)
    def grads(run, b, w):
        b = b.clone().requires_grad_()
        (g,) = torch.autograd.grad((run(b) * w).sum(), b)
        return g
    wgen = torch.Generator().manual_seed(14)
    w = torch.randn(tuple(rhs.shape), generator=wgen).to(dev)
    ap = svc.solver(ids[0]).arena
    pp = blockamc.pack_arena_plans([svc.solver(mid).arena for mid in ids])
    grad_launches = 0
    for what, run, b, ww in (
            ("execute_arena", partial(blockamc.execute_arena, ap), rhs[0],
             w[0]),
            ("execute_arena_packed",
             partial(blockamc.execute_arena_packed, pp), rhs, w)):
        arena_mvm.arena_packed_apply.launches = 0
        g_kernel = grads(run, b, ww)
        launched = arena_mvm.arena_packed_apply.launches
        grad_launches += launched
        g_plain = grads(partial(run, use_kernel=False), b, ww)
        if launched != 1 or arena_mvm.arena_packed_apply.launches != 1:
            _fail(f"{what}: the gradient's forward launched {launched}")
        _check_close(f"d sum(w x)/db through {what}'s kernel path (1 "
                     f"launch) vs plain path", g_kernel, g_plain,
                     SOLVE_REL_TOL)

    # the repair's cost: benchmarks/maint_bench.py repair_cost's config
    wv = AnalogConfig(array_size=n // 2, nonideal=NonidealConfig(
        sigma=0.02, r_wire=1.0, wire_model="first_order",
        compensate_wire=True, wv_iters=3))
    a = wishart(torch.Generator().manual_seed(7), n, device=dev)
    solver = blockamc.ProgrammedSolver.program(
        a, torch.Generator().manual_seed(1), wv, 2, device=dev)
    refs = [r.ref for r in solver.block_map()]
    k_rep = max(1, int(round(len(refs) / 8)))
    subset = refs[::max(1, len(refs) // k_rep)][:k_rep]
    program_ms = _host_ms(lambda: blockamc.ProgrammedSolver.program(
        a, torch.Generator().manual_seed(2), wv, 2, device=dev))
    repair_ms = _host_ms(lambda: solver.repaired(
        subset, torch.Generator().manual_seed(2)))
    print(f"  repair of {k_rep} of {len(refs)} arrays (n={n}, 128x128, "
          f"write-verify, wv_iters=3): {repair_ms:.3f} ms against a full "
          f"re-program's {program_ms:.3f} ms ({program_ms / repair_ms:.2f}x;"
          f" host clock, median of 3; card: {smi})")

    # wire calibration: benchmarks/grad_bench.py's n=16, 120 steps
    cg = torch.Generator().manual_seed(9)
    a = torch.randn(16, 16, generator=cg)
    a = (a @ a.T + 16 * torch.eye(16)).to(dev)
    banded_solve.block_tridiag_solve.launches = 0
    arena_mvm.arena_packed_apply.launches = 0
    t0 = time.perf_counter()
    cal = calibrate_wire(a, r_true=1.0, steps=120, device=dev)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    calib_banded = banded_solve.block_tridiag_solve.launches
    calib_arena = arena_mvm.arena_packed_apply.launches
    print(f"  calibrate_wire n=16, 120 steps: r_hat {cal.r_hat:.5f} ohm "
          f"(planted 1, error {cal.rel_err(1.0):.3%}, limit 5%), loss "
          f"{cal.history[0]:.3e} -> {cal.loss:.3e}; {calib_banded} "
          f"block-Thomas launches (the nodal oracle), {calib_arena} arena "
          f"launches; {t_cal:.2f} s wall (card: {smi})")
    if not cal.rel_err(1.0) < 0.05:
        _fail(f"calibration recovered {cal.r_hat} ohm, planted 1")
    if calib_banded == 0 or calib_arena != 121:
        _fail(f"calibration launched {calib_banded} block-Thomas and "
              f"{calib_arena} arena kernels (expected 121: the oracle and "
              f"one a step)")
    return {"maintained flush_all (phase 13)": flush_launches,
            "kernel-path gradients (phase 13)": grad_launches,
            "calibrate_wire forwards (phase 13)": calib_arena,
            "calibrate_wire nodal oracle (phase 13)": calib_banded,
            "repair_ms": repair_ms, "program_ms": program_ms,
            "calibration_s": t_cal, "r_hat": cal.r_hat}


# The serving benches' full runs (benchmarks/router_bench.py:151-152,
# benchmarks/engine_bench.py:132-133): tenants, requests, Poisson rate in
# Hz, deadline in s.  Phase 14 holds each bench's per-tenant rate and
# requests at its own tenant count, so the offered load grows with them.
ROUTER_BENCH = (4, 160, 150.0, 5.0)
ENGINE_BENCH = (8, 200, 150.0, 5.0)


def _fleet_phase(dev, smi, root, n=256, tenants=16, replicas=3):
    """Phase 14: the async serving engine and the replicated fleet on the
    card at Fig. 8's configuration.  The fleet runs `router_bench.py`'s
    seeded open-loop Poisson trace, and the faulted engine
    `engine_bench.py`'s, each at 16 tenants with the bench's per-tenant
    rate, per-tenant requests and deadline (`ROUTER_BENCH`,
    `ENGINE_BENCH`); one trace serves every fleet scenario.  Scenarios:
    the fleet with 1 and with 3 replicas, each then given a burst of the
    trace's first `max_pending` requests back to back (the most one
    replica admits) for its capacity; r0's worker killed mid-traffic, the
    replacement restoring from the `ProgramStore` (`death_restore`) or,
    every checkpoint value-corrupted, re-programming (`death_reprogram`);
    `engine_bench.py`'s faulted run on one engine.  Every answer is held
    to the plain path of the plan that answered it.  Returns the launch
    counts and the scenarios' numbers."""
    import tempfile
    from repro_torch import keys
    from repro_torch.checkpoint import ProgramStore
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.core import blockamc
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.data.matrices import wishart
    from repro_torch.kernels import arena_mvm
    from repro_torch.runtime import (ChaosInjector, DeviceFault,
                                     DispatchException, ReplicaDeath)
    from repro_torch.serve import (AsyncSolverEngine, ReplicatedSolverFleet,
                                   SolverService)
    cfg = AnalogConfig(array_size=64, nonideal=NonidealConfig(sigma=0.05))
    # engine_bench.py's fault: stuck-at arrays no re-program key can pass
    severe = NonidealConfig(sigma=0.02, p_stuck_off=0.6, g_stuck_off=0.0)
    # router_bench.py's engine settings
    engine_kw = dict(max_batch=8, flush_interval=0.01, max_pending=512,
                     retries=2, backoff=0.0)

    def make_trace(bench):
        """`bench`'s seeded open-loop trace at `tenants` tenants."""
        m, total, rate, deadline = bench
        requests, rate_hz = total * tenants // m, rate * tenants / m
        rng = np.random.default_rng(14)
        return dict(
            requests=requests, rate_hz=rate_hz, deadline_s=deadline,
            arrivals=np.cumsum(rng.exponential(1.0 / rate_hz, requests)),
            who=rng.integers(0, tenants, requests),
            rhs=rng.uniform(-1.0, 1.0, size=(requests, n)).astype(np.float32))

    fleet_tr, engine_tr = make_trace(ROUTER_BENCH), make_trace(ENGINE_BENCH)
    for what, bench, tr in (("fleet", ROUTER_BENCH, fleet_tr),
                            ("faulted engine", ENGINE_BENCH, engine_tr)):
        print(f"phase 14: {what}, n={n} stages=2 64x64 sigma=0.05, "
              f"{tenants} tenants, {tr['requests']} Poisson arrivals at "
              f"{tr['rate_hz']:g} Hz, deadline {tr['deadline_s']:g} s (the "
              f"bench's {bench[1]} requests at {bench[2]:g} Hz over "
              f"{bench[0]} tenants, held per tenant); card: {smi}")
    data = torch.Generator().manual_seed(14)
    mats = [wishart(data, n, device="cpu").numpy() for _ in range(tenants)]
    ids = [f"b{i}" for i in range(tenants)]
    base = keys.PRNGKey(14)
    tkeys = [keys.fold_in(base, 100 + i) for i in range(tenants)]

    def plain_answers(tr, solver, mid):
        """The plain path's answers of `solver` to every rhs of `mid`."""
        rows = np.flatnonzero(tr["who"] == ids.index(mid))
        b = torch.from_numpy(tr["rhs"][rows].T.copy()).to(dev)
        x = blockamc.execute_arena(solver.arena, b, use_kernel=False)
        return dict(zip(rows.tolist(), x.T.cpu().numpy()))

    def same_stacks(a, b, what):
        for (k1, x1), (k2, x2) in zip(
                flatten({"fin": a.finalized, "arena": a.arena}),
                flatten({"fin": b.finalized, "arena": b.arena})):
            if k1 != k2 or not torch.equal(x1, x2):
                _fail(f"{what}: leaf {k1} differs")

    def drive(tr, submit, burst=None):
        """The trace through `submit`, open loop; or, given `burst`, its
        first `burst` requests back to back.  (results, wall s)."""
        futs = []
        t0 = time.perf_counter()
        for i in range(burst or tr["requests"]):
            lag = tr["arrivals"][i] - (time.perf_counter() - t0)
            if lag > 0 and not burst:
                time.sleep(lag)
            futs.append(submit(ids[tr["who"][i]], tr["rhs"][i]))
        results = [f.result(timeout=120) for f in futs]   # typed error raises
        return results, time.perf_counter() - t0

    def check_answers(label, tr, results, plans):
        """Each answer within SOLVE_REL_TOL of max|x| of its plan's plain
        path; `plans(i, result)` names the answering plan's answers."""
        worst = 0.0
        for i, res in enumerate(results):
            if res.matrix_id != ids[tr["who"][i]] or res.mode != "analog":
                _fail(f"{label}: request {i} answered by {res.matrix_id} "
                      f"in mode {res.mode}")
            ref_x = plans(i, res)[i]
            err = float(np.max(np.abs(res.x - ref_x)))
            rel = err / float(np.max(np.abs(ref_x)))
            worst = max(worst, rel)
            if not rel <= SOLVE_REL_TOL:
                _fail(f"{label}: request {i} ({res.matrix_id}) is "
                      f"{rel:.3e} of max|x| from its plan's plain path")
        return worst

    def summary(label, results, wall, launches, dispatches, extra=""):
        lat = np.array([r.latency_s for r in results]) * 1e3
        misses = sum(r.deadline_missed for r in results)
        st = dict(p50_ms=float(np.percentile(lat, 50)),
                  p99_ms=float(np.percentile(lat, 99)),
                  wall_s=wall, offered_rps=len(results) / wall,
                  goodput_rps=(len(results) - misses) / wall,
                  misses=misses, launches=launches, dispatches=dispatches)
        print(f"  {label}: p50 {st['p50_ms']:.2f} ms, p99 "
              f"{st['p99_ms']:.2f} ms, goodput {st['goodput_rps']:.1f}/s "
              f"of {st['offered_rps']:.1f}/s offered, {misses} deadline "
              f"misses, {dispatches} dispatches, {launches} arena launches"
              f"{extra} (host clock; card: {smi})")
        if launches < dispatches:
            _fail(f"{label}: {launches} arena launches for {dispatches} "
                  f"dispatches")
        return st

    out, launches = {}, {}
    scratch = root / "artifacts"
    scratch.mkdir(exist_ok=True)
    deadline_s = fleet_tr["deadline_s"]
    scenarios = [
        ("baseline_1", 1, (), None),
        ("baseline_3", replicas, (), None),
        ("death_restore", replicas,
         (ReplicaDeath(at_dispatch=2, replica="r0"),), None),
        ("death_reprogram", replicas,
         (ReplicaDeath(at_dispatch=2, replica="r0"),),
         lambda store: [store.corrupt(mid, "values")
                        for mid in store.matrix_ids()]),
    ]
    for label, n_rep, events, damage in scenarios:
        chaos = ChaosInjector(list(events)) if events else None
        with tempfile.TemporaryDirectory(dir=scratch) as store_dir:
            store = ProgramStore(store_dir)
            fleet = ReplicatedSolverFleet(
                lambda: SolverService(cfg, stages=2), n_rep,
                engine_kw=engine_kw, store=store, chaos=chaos)
            with fleet:
                t0 = time.perf_counter()
                for mid, a, key in zip(ids, mats, tkeys):
                    fleet.program(mid, a, key)
                t_prog = time.perf_counter() - t0
                lead = fleet._replicas[0].engine.service
                for r in fleet._replicas[1:]:
                    for mid in ids:
                        same_stacks(lead.solver(mid),
                                    r.engine.service.solver(mid),
                                    f"{label}: {r.name}'s {mid} vs r0's")
                solvers = {mid: lead.solver(mid) for mid in ids}
                expect = {}
                for mid in ids:
                    expect.update(plain_answers(fleet_tr, solvers[mid], mid))
                if damage is not None:
                    damage(store)
                engines = [r.engine for r in fleet._replicas]
                torch.cuda.synchronize()
                arena_mvm.arena_packed_apply.launches = 0
                results, wall = drive(fleet_tr, lambda mid, b: fleet.submit(
                    mid, b, deadline_s=deadline_s))
                if events and not _wait_for(
                        lambda: fleet.stats.replacements >= 1, 120.0):
                    _fail(f"{label}: the dead replica was not replaced")
                burst = None
                if not events:         # capacity: the most a replica admits
                    before = [e.stats.dispatches for e in engines]
                    burst, burst_wall = drive(
                        fleet_tr, fleet.submit,
                        burst=min(engine_kw["max_pending"],
                                  fleet_tr["requests"]))
                    burst_dispatches = [e.stats.dispatches - d
                                        for e, d in zip(engines, before)]
                torch.cuda.synchronize()
                count = arena_mvm.arena_packed_apply.launches
                engines += [r.engine for r in fleet._replicas
                            if r.engine not in engines]
                if events:             # the replacement's plans, by bits
                    fresh = fleet._replicas[0]
                    for mid in ids:
                        same_stacks(solvers[mid],
                                    fresh.engine.service.solver(mid),
                                    f"{label}: the replacement's {mid}")
            fs = fleet.stats
        worst = check_answers(label, fleet_tr, results,
                              lambda i, res: expect)
        dispatches = sum(e.stats.dispatches for e in engines)
        rec_ms = 1e3 * sum(fs.restore_s or fs.reprogram_s)
        extra = (f"; programmed {tenants} x {n_rep} in {t_prog:.2f} s, "
                 f"worst answer {worst:.2e} of max|x|")
        if events:
            extra += (f"; {fs.replays} replays, {fs.restores} restores, "
                      f"{fs.reprogram_fallbacks} re-programs, "
                      f"{fs.rejected_checkpoints} rejected checkpoints, "
                      f"recovery {rec_ms:.1f} ms")
        st = summary(label, results, wall, count, dispatches, extra)
        st.update(program_s=t_prog, worst_rel_err=worst,
                  replays=fs.replays, hedges=fs.hedges,
                  restores=fs.restores,
                  reprogram_fallbacks=fs.reprogram_fallbacks,
                  rejected_checkpoints=fs.rejected_checkpoints,
                  recovery_ms=rec_ms, deaths=fs.deaths)
        if burst is not None:
            burst_worst = check_answers(f"{label} burst", fleet_tr, burst,
                                        lambda i, res: expect)
            st.update(capacity_rps=len(burst) / burst_wall,
                      burst_dispatches_by_replica=burst_dispatches,
                      burst_worst_rel_err=burst_worst)
            print(f"  {label} burst: {len(burst)} requests back to back "
                  f"answered in {burst_wall:.3f} s = "
                  f"{st['capacity_rps']:.1f}/s, dispatches by replica "
                  f"{burst_dispatches}, worst answer {burst_worst:.2e} of "
                  f"max|x| (host clock; card: {smi})")
        # a replica's loss: only the replayed legs may miss a deadline
        if st["misses"] > (fs.replays if events else 0):
            _fail(f"{label}: {st['misses']} deadline misses, "
                  f"{fs.replays} replays")
        if label == "death_restore" and (
                fs.restores != tenants or fs.reprogram_fallbacks):
            _fail(f"{label}: {fs.restores} restores, "
                  f"{fs.reprogram_fallbacks} re-programs")
        if label == "death_reprogram" and (
                fs.reprogram_fallbacks != tenants or fs.restores
                or fs.rejected_checkpoints != tenants):
            _fail(f"{label}: {fs.reprogram_fallbacks} re-programs, "
                  f"{fs.restores} restores, {fs.rejected_checkpoints} "
                  f"rejected")
        if events and fs.deaths != 1:
            _fail(f"{label}: {fs.deaths} replica deaths")
        out[label] = st
        launches[label] = count
    ratio = (out["death_reprogram"]["recovery_ms"]
             / out["death_restore"]["recovery_ms"])
    out["recovery_ratio"] = ratio
    print(f"  recovery: re-program {out['death_reprogram']['recovery_ms']:.1f}"
          f" ms / restore {out['death_restore']['recovery_ms']:.1f} ms = "
          f"{ratio:.2f}x; capacity 3 vs 1 replicas: "
          f"{out['baseline_3']['capacity_rps']:.1f} vs "
          f"{out['baseline_1']['capacity_rps']:.1f}/s (card: {smi})")

    # engine_bench.py's faulted run: one engine, DispatchException at 3, a
    # stuck-at DeviceFault on b0 at 5
    chaos = ChaosInjector([
        DispatchException(at_dispatch=3),
        DeviceFault(at_dispatch=5, matrix_id="b0", nonideal=severe)])
    eng = AsyncSolverEngine(SolverService(cfg, stages=2), max_batch=8,
                            flush_interval=0.02, max_pending=512, retries=2,
                            backoff=0.0, chaos=chaos)
    for mid, a, key in zip(ids, mats, tkeys):
        eng.program(mid, a, key)
    original = {mid: eng.service.solver(mid) for mid in ids}
    with eng:
        torch.cuda.synchronize()
        arena_mvm.arena_packed_apply.launches = 0
        results, wall = drive(engine_tr, lambda mid, b: eng.submit(
            mid, b, deadline_s=engine_tr["deadline_s"]))
        torch.cuda.synchronize()
        count = arena_mvm.arena_packed_apply.launches
    es = eng.stats
    fired = [(i, type(e).__name__) for i, e in chaos.log]
    if fired != [(3, "DispatchException"), (5, "DeviceFault")] or \
            es.quarantines != 1 or es.reprograms != 1 or \
            eng.matrix_status("b0") != "healthy":
        _fail(f"faulted engine: log {fired}, {es.quarantines} quarantines, "
              f"{es.reprograms} re-programs, b0 {eng.matrix_status('b0')}")
    expect = {}
    for mid in ids:
        expect.update(plain_answers(engine_tr, original[mid], mid))
    recovered = plain_answers(engine_tr, eng.service.solver("b0"), "b0")
    worst = check_answers("faulted engine", engine_tr, results,
                          lambda i, res: (recovered if res.reprograms
                                          else expect))
    healthy_misses = sum(r.deadline_missed for r in results
                         if r.matrix_id != "b0")
    if healthy_misses:
        _fail(f"faulted engine: {healthy_misses} deadline misses among "
              f"healthy tenants")
    st = summary("faulted engine", results, wall, count,
                 es.dispatches - es.retries,
                 f"; {es.retries} retries, {es.quarantines} quarantine, "
                 f"{es.replays} replays, recovery "
                 f"{1e3 * es.recovery_s[0]:.1f} ms, worst answer "
                 f"{worst:.2e} of max|x|")
    st.update(recovery_ms=1e3 * es.recovery_s[0], worst_rel_err=worst,
              quarantines=es.quarantines, replays=es.replays)
    out["faulted_engine"] = st
    launches["faulted_engine"] = count
    return launches, out


def _wait_for(cond, timeout):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _xbar_bound(l, b, r, c, bits):
    """Least time of one float32 crossbar call: v and both conductance
    stacks read once, the output written once over HBM; against the
    products, 2*L*B*R*C flops, at the card's fastest route to float32
    with the DAC's output as one operand (`_f32_product_s`: three bf16
    products on codes of up to 9 bits, 3xTF32 on an ideal DAC)."""
    return _roofline_s(4 * (l * b * c + 2 * l * r * c + l * b * r),
                       _f32_product_s(2 * l * b * r * c, bits))


def _schur_bound(i, j, k, size=4):
    """Least time of one Schur call: a4, a3, w (`size` bytes each) read
    once, the float32 output written once; the products at the card's
    fastest rate for the function: bf16 inputs as 2*I*J*K flops on the
    bf16 tensor cores (bf16 products are exact in f32 with an f32 sum),
    float32 as 3xTF32, three products of 2*I*J*K flops on the tf32 tensor
    cores (as close to the f32 function as f32 FMAs, and faster than the
    CUDA cores' 67 TFLOP/s)."""
    if size == 2:
        return _roofline(2 * (i * j + i * k + k * j) + 4 * i * j,
                         2 * i * j * k, BF16_FLOP_PER_S)
    return _roofline(4 * (2 * i * j + i * k + k * j), 3 * 2 * i * j * k,
                     TF32_FLOP_PER_S)


def _bench_phase(dev):
    """Phase 9: the kernel bench's rows on the three kernels of slice 3.

    Every row is one check-run of the kernel through its public entry
    point (`kernels.ops`) and timed runs of the same call (back to back,
    and replayed from a CUDA graph, which leaves out the host's launch
    cost) - the path of
    `benchmarks/kernel_bench.py`'s crossbar, batched and Schur rows - with
    the launch counts read over the rows.  Each row's check-run output is
    then held against the plain version on the same inputs (no further
    launch): 1e-5 of max|out| ideal; with 8-bit converters at most one
    ADC step on at most 2% of outputs.  Returns (stats, launches)."""
    from repro_torch.core import blockamc
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.data.matrices import wishart
    from repro_torch.kernels import crossbar_mvm, ops, ref, schur_gemm
    print("phase 9: crossbar, batched crossbar and Schur kernels at the "
          "kernel bench's shapes, against their plain versions")
    g0 = 100e-6
    gen = torch.Generator(device=dev).manual_seed(9)

    def uniform(shape, lo, hi, dtype=torch.float32):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo)
                + lo).to(dtype)

    rows = []       # (key, label, kernel fn, plain fn, library fn, bound,
    #                  bits, dtype)
    for b, r, c in ((256, 512, 512), (512, 1024, 1024)):
        v = uniform((b, c), -1, 1)
        gp, gn = uniform((r, c), 0, g0), uniform((r, c), 0, g0)
        for bits in (8, None):
            kw = dict(g0=g0, dac_bits=bits, adc_bits=bits)
            rows.append((
                "crossbar_mvm", f"crossbar ({b},{r},{c}) "
                f"{'8-bit' if bits else 'ideal'}",
                lambda v=v, gp=gp, gn=gn, kw=kw: ops.crossbar_mvm(
                    v, gp, gn, **kw),
                lambda v=v, gp=gp, gn=gn, kw=kw: ref.crossbar_mvm_ref(
                    v, gp, gn, **kw), None, _xbar_bound(1, b, r, c, bits),
                bits))
    for l, b, r, c in ((16, 64, 64, 64), (16, 128, 128, 128)):
        v = uniform((l, b, c), -1, 1)
        gp, gn = uniform((l, r, c), 0, g0), uniform((l, r, c), 0, g0)
        kw = dict(g0=g0, dac_bits=8, adc_bits=8)
        rows.append((
            "crossbar_mvm_batched", f"batched ({l},{b},{r},{c}) 8-bit",
            lambda v=v, gp=gp, gn=gn, kw=kw: ops.crossbar_mvm_batched(
                v, gp, gn, **kw),
            lambda v=v, gp=gp, gn=gn, kw=kw: ref.crossbar_mvm_batched_ref(
                v, gp, gn, **kw), None, _xbar_bound(l, b, r, c, 8), 8))
    # one INV bucket stack of the Fig. 8 configuration's flat plan
    cfg = AnalogConfig(array_size=64, nonideal=NonidealConfig(sigma=0.05))
    a = wishart(torch.Generator().manual_seed(8), 256, device=dev)
    fplan = blockamc.compile_plan(blockamc.program_system(
        blockamc.partition_system(a, cfg, 2),
        torch.Generator().manual_seed(80), cfg))
    grid = fplan.inv_stacks[0]
    num, s, _ = grid.shape
    v = uniform((num, 8, s), -1, 1)
    rows.append((
        "crossbar_mvm_batched", f"batched Fig. 8 INV stack ({num},8,{s},{s})",
        lambda v=v: ops.crossbar_mvm_batched(v, grid.gpos, grid.gneg,
                                             g0=cfg.g0),
        lambda v=v: ref.crossbar_mvm_batched_ref(v, grid.gpos, grid.gneg,
                                                 g0=cfg.g0), None,
        _xbar_bound(num, 8, s, s, None), None))
    for n, dtype in ((512, torch.float32), (1024, torch.float32),
                     (128, torch.bfloat16)):
        a4, a3, w = (torch.randn((n, n), generator=gen, device=dev
                                 ).to(dtype) for _ in range(3))
        rows.append((
            "schur_update", f"Schur n={n} {str(dtype)[6:]}",
            lambda a4=a4, a3=a3, w=w: ops.schur_update(a4, a3, w),
            lambda a4=a4, a3=a3, w=w: ref.schur_update_ref(a4, a3, w),
            lambda a4=a4, a3=a3, w=w: torch.addmm(a4, a3, w, alpha=-1),
            _schur_bound(n, n, n, 2 if dtype == torch.bfloat16 else 4),
            None))

    counters = {"crossbar_mvm": crossbar_mvm.crossbar_mvm,
                "crossbar_mvm_batched": crossbar_mvm.crossbar_mvm_batched,
                "schur_update": schur_gemm.schur_update}
    for fn in counters.values():
        fn.launches = 0
    outs = []
    for key, label, kernel, *_ in rows:      # the bench rows: check-run,
        out = kernel()                       # then the timed runs
        big = "1024" in label
        ms = _time_ms(kernel, reps=7, per_batch=5 if big else 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()             # the host's cost of a call:
        for _ in range(20):                  # enqueueing, no waiting
            kernel()
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        outs.append((out, ms, _graph_ms(kernel), host_us))
    torch.cuda.synchronize()
    launches = {key: fn.launches for key, fn in counters.items()}
    print(f"  launches over the bench rows: {launches}")
    for key, n_launch in launches.items():
        if n_launch == 0:
            _fail(f"the bench rows never launched {key}")
    stats = {}
    for (key, label, _, plain, library, (bound_ms, bound_by), bits), \
            (out, ms, graph_ms, host_us) in zip(rows, outs):
        want = plain()
        if bits is None:
            err = _check_close(label, out, want, KERNEL_REL_TOL)
        else:
            err = _check_one_step(label, out, want, 2.0 / (2 ** bits - 1))
        plain_ms = _time_ms(plain, reps=5, per_batch=5)
        plain_graph_ms = _graph_ms(plain)
        lib_ms = lib_graph_ms = None
        lib = ""
        if library is not None:
            lib_ms = _time_ms(library, reps=7, per_batch=20)
            lib_graph_ms = _graph_ms(library)
            lib = (f", torch.addmm {lib_ms:.4f} ms (graph "
                   f"{lib_graph_ms:.4f}; the kernel takes "
                   f"{ms / lib_ms:.3f}x its time, graph "
                   f"{graph_ms / lib_graph_ms:.3f}x)")
        print(f"  kernel {ms:.4f} ms (graph {graph_ms:.4f}; the host "
              f"{host_us:.1f} us a call), plain "
              f"{plain_ms:.4f} ms (graph {plain_graph_ms:.4f}){lib}, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.2%} of the "
              f"bound ({bound_ms / graph_ms:.2%} of graph time)")
        stats.setdefault(key, {})[label] = dict(
            err=err, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
            plain_graph_ms=plain_graph_ms, library_ms=lib_ms,
            library_graph_ms=lib_graph_ms,
            library_ratio=None if lib_ms is None else ms / lib_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            host_us=host_us)
    return stats, launches


def _check_one_step(what, out, ref, step, share=0.02):
    """One converter, its input sum reassociated: outputs agree to
    KERNEL_REL_TOL of max|ref|, but at most `share` of them may land one
    ADC step away (an input within rounding of a bin edge)."""
    err = (out.double() - ref.double()).abs()
    scale = KERNEL_REL_TOL * float(ref.double().abs().max())
    off = float((err > scale).double().mean())
    print(f"  {what}: max abs err {float(err.max()):.3e} (step {step:.3e}),"
          f" {off:.3%} of outputs a step away (limit {share:.0%})")
    if not (float(err.max()) <= step * (1 + 1e-5) + scale and off <= share):
        _fail(f"{what}: converter outputs disagree beyond one-step flips")
    return float(err.max())


class _Counted:
    """A preconditioner that counts its applications."""

    def __init__(self, prec):
        self.prec, self.calls = prec, 0

    def __call__(self, v):
        self.calls += 1
        return self.prec(v)


def _example_phase(dev, svc, mid, a_svc):
    """Phase 10: the example's path (`examples/solve_linear_system.py`) at
    its own widths, with the hybrid benchmark's headline Krylov runs and
    the Fig. 8 service's refined paths; returns the launch counts of the
    arena and crossbar kernels."""
    from repro_torch.core import area_energy, blockamc, distributed
    from repro_torch.core.analog import AnalogConfig, map_tiled_vec
    from repro_torch.core.metrics import relative_error
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.data.matrices import random_rhs, wishart, \
        wishart_with_cond
    from repro_torch.hybrid import (AnalogPreconditioner, gmres, krylov,
                                    matvec_from_dense, pcg, solve_refined)
    from repro_torch.kernels import arena_mvm, crossbar_mvm, ops, ref
    print("phase 10: the example's path - distributed n=1024 stages=3 "
          "128x128, programmed 256 two-stage 64x64 with 16 rhs, hybrid "
          "refinement, crossbar check, area/energy")
    arena_mvm.arena_packed_apply.launches = 0
    crossbar_mvm.crossbar_mvm.launches = 0
    krylov.any_active.reads = 0
    data = torch.Generator().manual_seed(0)
    n = 1024
    a = wishart(data, n, device=dev)
    b = random_rhs(data, n, device=dev)
    x_true = torch.linalg.solve(a.double(), b.double())
    for sigma in (0.0, 0.01, 0.05):
        cfg = AnalogConfig(array_size=128,
                           nonideal=NonidealConfig(sigma=sigma))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = distributed.solve_distributed(a, b, torch.Generator().manual_seed(
            1), cfg, stages=3, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        err = float(relative_error(x_true, x.double()))
        print(f"  distributed n={n} stages=3 sigma={sigma}: paper metric "
              f"{err:.3e}, {wall:.3f} s wall")
        if tuple(x.shape) != (n,) or not bool(torch.isfinite(x).all()):
            _fail(f"distributed sigma={sigma}: wrong shape or non-finite")
        if sigma == 0.0 and not err < DIST_IDEAL_TOL:
            _fail(f"ideal distributed solve error {err:.3e} >= "
                  f"{DIST_IDEAL_TOL:g}")

    cfg64 = AnalogConfig(array_size=64, nonideal=NonidealConfig(sigma=0.05))
    a256 = a[:256, :256].contiguous()
    t0 = time.perf_counter()
    solver = blockamc.ProgrammedSolver.program(
        a256, torch.Generator().manual_seed(2), cfg64, 2, device=dev)
    bs = torch.randn((256, 16), generator=torch.Generator().manual_seed(3)
                     ).to(dev)
    xs = solver.solve_many(bs)
    torch.cuda.synchronize()
    xs_ref = torch.linalg.solve(a256.double(), bs.double())
    errs = relative_error(xs_ref.T, xs.double().T)
    print(f"  programmed 256x256 two-stage solver, 16 rhs: median paper "
          f"metric {float(errs.median()):.3f} ({solver.finalized.num_arrays}"
          f" arrays; program + solve {time.perf_counter() - t0:.3f} s)")
    if not bool(torch.isfinite(xs).all()):
        _fail("programmed solver answered non-finite")
    # the arena kernel at this program's shapes against the plain cascade
    # (which launches nothing, so the counts below stay the path's own)
    _check_close("programmed solve_many vs plain arena cascade", xs,
                 blockamc.execute_arena(solver.arena, bs, use_kernel=False),
                 SOLVE_REL_TOL)

    precond = AnalogPreconditioner.from_solver(solver)
    before = arena_mvm.arena_packed_apply.launches
    reads0 = krylov.any_active.reads
    t0 = time.perf_counter()
    # the digital side in float64: at tol 1e-6 a float32 exit residual
    # sits at its own rounding floor (~eps * sqrt(n) * cond) and may
    # report a converged column as not converged
    xs_refined, info = solve_refined(a256.double(), bs.double(), precond,
                                     method="cg", tol=1e-6, maxiter=300,
                                     use_precond=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    errs = relative_error(xs_ref.T, xs_refined.double().T)
    refine_launches = arena_mvm.arena_packed_apply.launches - before
    reads = krylov.any_active.reads - reads0
    print(f"  hybrid refined (f32 analog seed + f64 CG, tol 1e-6): median "
          f"paper metric "
          f"{float(errs.median()):.3e}, median iters "
          f"{int(info.iters.median())}, max {int(info.iters.max())}, all "
          f"converged {bool(info.converged.all())}; {wall:.3f} s wall, "
          f"{refine_launches} arena launch(es), {reads} host reads")
    if not bool(info.converged.all()):
        _fail("refined solve did not converge on every rhs")
    if refine_launches != 1:
        _fail(f"seed-only refinement launched the arena kernel "
              f"{refine_launches} times, expected 1 (the seed)")

    # the hybrid benchmark's headline: n=64, cond 1e4, float64 digital side
    hl = torch.Generator().manual_seed(4)
    a64 = wishart_with_cond(hl, 64, 1e4, dtype=torch.float64, device=dev)
    b64 = random_rhs(hl, 64, dtype=torch.float64, device=dev)
    mv = matvec_from_dense(a64)
    plain = pcg(mv, b64, tol=1e-10, maxiter=4000)
    for method, cfg in (
            ("cg", AnalogConfig(array_size=32, opa_gain=1e5)),
            ("gmres", AnalogConfig(array_size=32, nonideal=NonidealConfig(
                sigma=1e-4, r_wire=1.0, compensate_wire=True)))):
        prec = _Counted(AnalogPreconditioner.program(
            a64.float(), torch.Generator().manual_seed(5), cfg, 1,
            device=dev))
        if prec.prec.aplan.program is None:
            _fail(f"headline {method} plan is not uniform")
        before = arena_mvm.arena_packed_apply.launches
        reads0 = krylov.any_active.reads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x0 = prec(b64)
        if method == "cg":
            res = pcg(mv, b64, precond=prec, x0=x0, tol=1e-10, maxiter=4000)
        else:
            res = gmres(mv, b64, precond=prec, x0=x0, tol=1e-10, restart=16,
                        maxiter=4000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = arena_mvm.arena_packed_apply.launches - before
        reads = krylov.any_active.reads - reads0
        _check_close(f"headline {method} seed vs plain arena cascade", x0,
                     blockamc.execute_arena(prec.prec.aplan, b64.float(),
                                            use_kernel=False),
                     SOLVE_REL_TOL)
        print(f"  headline preconditioned {method}: {int(res.iters)} iters "
              f"(plain CG {int(plain.iters)}), resnorm "
              f"{float(res.resnorm):.2e}, converged {bool(res.converged)}; "
              f"{prec.calls} preconditioner applications, {launched} arena "
              f"launches, {reads} host reads, {wall * 1e3:.1f} ms wall")
        if not bool(res.converged):
            _fail(f"headline {method} did not converge")
        if launched != prec.calls:
            _fail(f"headline {method}: {launched} arena launches for "
                  f"{prec.calls} preconditioner applications")

    # the example's crossbar check on a mapped 256x256 tile grid
    cfg128 = AnalogConfig(array_size=128, nonideal=NonidealConfig(sigma=0.05))
    scale = 1.0 / torch.max(torch.abs(a))
    grid = map_tiled_vec(a256, torch.Generator().manual_seed(6), cfg128,
                         scale)
    gpos = grid.gpos.reshape(-1, 256)[:256]
    gneg = grid.gneg.reshape(-1, 256)[:256]
    v = random_rhs(data, 256, device=dev)[None, :]
    out_kernel = ops.crossbar_mvm(v, gpos, gneg, g0=cfg128.g0, dac_bits=8,
                                  adc_bits=8)
    out_ref = ref.crossbar_mvm_ref(v, gpos, gneg, g0=cfg128.g0, dac_bits=8,
                                   adc_bits=8)
    torch.cuda.synchronize()
    _check_one_step("example crossbar_mvm vs plain version", out_kernel,
                    out_ref, 2.0 / (2 ** 8 - 1))

    # the Fig. 8 service's refined paths, on tenant `mid` (matrix a_svc)
    st0 = dataclasses.replace(svc.stats(mid))
    rhs = torch.rand((256, 4), generator=torch.Generator().manual_seed(7)
                     ).to(dev) * 2 - 1
    t0 = time.perf_counter()
    x_one = svc.solve_refined(mid, rhs[:, :2])
    for j in range(2, 4):
        svc.submit(mid, rhs[:, j])
    x_flush = svc.flush(mid, refined=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    x_svc = torch.cat([x_one, x_flush], dim=1)
    x64 = torch.linalg.solve(a_svc.double(), rhs.double())
    err = float(relative_error(x64.T, x_svc.double().T).max())
    st = svc.stats(mid)
    print(f"  service {mid}: solve_refined (2 rhs) + flush(refined=True) "
          f"(2 rhs): paper metric {err:.3e} vs float64, refined_calls "
          f"{st0.refined_calls}->{st.refined_calls}, refine_iters "
          f"{st0.refine_iters}->{st.refine_iters}; {wall * 1e3:.1f} ms wall")
    if st.refined_calls != st0.refined_calls + 2 or not err < REFINED_TOL:
        _fail(f"service refined paths: {st.refined_calls} calls, error "
              f"{err:.3e} (limit {REFINED_TOL:g})")

    sav = area_energy.savings(area_energy.report())
    print(f"  hardware verdict (512x512): one-stage saves "
          f"{sav['area']['one_stage']:.1%} area / "
          f"{sav['power']['one_stage']:.1%} power, two-stage "
          f"{sav['area']['two_stage']:.1%} / {sav['power']['two_stage']:.1%}"
          f" vs a monolithic AMC")
    torch.cuda.synchronize()
    counts = {"arena_packed_apply": arena_mvm.arena_packed_apply.launches,
              "crossbar_mvm": crossbar_mvm.crossbar_mvm.launches}
    print(f"  launches on the example's path: {counts}; host reads of the "
          f"Krylov loops {krylov.any_active.reads}")
    if counts["crossbar_mvm"] != 1 or counts["arena_packed_apply"] == 0:
        _fail(f"example path launches {counts}")
    return counts


def _flash_bound(bh, s, d, dtype, causal):
    """Least time of one attention call: q, k, v read once and out written
    once over HBM; 4*BH*D flops per live (row, key) pair - S(S+1)/2 of
    them causal, S^2 full - at the card's rate for the function: bf16 on
    the bf16 tensor cores (bf16 products are exact), float32 as 3xTF32
    (three tf32 products each) on the tf32 tensor cores."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * bh * d * pairs
    if dtype == torch.bfloat16:
        return _roofline(4 * bh * s * d * 2, flops, BF16_FLOP_PER_S)
    return _roofline(4 * bh * s * d * 4, 3 * flops, TF32_FLOP_PER_S)


def _flash_phase(dev):
    """Phase 11: the attention kernel against its plain version on the
    card, at the phase-12 prefill's own shape (BH, S, D) = (128, 1024,
    128) in bf16 and in f32 (the float32 route check's), a long (32, 8192,
    128) bf16, a ragged (8, 1000, 64) f32 and a full (non-causal) (16,
    1024, 128) f32.  float32: KERNEL_REL_TOL of
    max|out|; bfloat16: against the plain version evaluated in float32 on
    the same bf16 inputs, element by element (`_check_bf16_rounding`: the
    kernel rounds its float32 result to bf16 once).  Each row is timed
    beside the plain version and `scaled_dot_product_attention` on the
    same tensors (timed only; the port never calls it).  Returns {label: stats}."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    print("phase 11: attention kernel vs plain version on the card")
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = [("serving prefill", 128, 1024, 128, torch.bfloat16, True),
             ("serving prefill, float32", 128, 1024, 128, torch.float32,
              True),
             ("long prefill", 32, 8192, 128, torch.bfloat16, True),
             ("ragged S", 8, 1000, 64, torch.float32, True),
             ("full attention", 16, 1024, 128, torch.float32, False)]
    stats = {}
    for label, bh, s, d, dtype, causal in cases:
        what = (f"{label}: (BH, S, D) = ({bh}, {s}, {d}) {str(dtype)[6:]}"
                f"{'' if causal else ' non-causal'}")
        q, k, v = (torch.randn((bh, s, d), generator=gen, device=dev
                               ).to(dtype) for _ in range(3))
        out = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        f32 = [x.float() for x in (q, k, v)]
        want = ref.flash_attention_ref(*f32, causal=causal)
        if dtype == torch.float32:
            err, ratio = _check_close(what, out, want, KERNEL_REL_TOL), None
        else:
            err, ratio = _check_bf16_rounding(what, out, want)
        if out.dtype != dtype or out.shape != q.shape:
            _fail(f"{what}: output {out.dtype} {tuple(out.shape)}")
        del want, f32
        ms = _time_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                      reps=5, per_batch=3)
        plain_ms = _time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal), reps=3, per_batch=1)
        # (1, BH, S, D): the 4-D layout its fused kernels take
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal), reps=5,
            per_batch=3)
        bound_ms, bound_by = _flash_bound(bh, s, d, dtype, causal)
        print(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {lib_ms:.4f} ms (the kernel "
              f"takes {ms / lib_ms:.3f}x its time), bound {bound_ms:.4f} ms "
              f"({bound_by}), {bound_ms / ms:.2%} of the bound")
        stats[label] = dict(err=err, bf16_ratio=ratio, ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            library_ratio=ms / lib_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        if label == "serving prefill":      # the op against the launch
            if not torch.equal(out, _flash_launch(ops, q, k, v, causal)):
                _fail(f"{what}: the op's output differs from the launch's")
        del q, k, v, out
        torch.cuda.empty_cache()
    stats["host_us"] = _flash_host_us(ops, gen, dev)
    return stats


def _flash_launch(ops, q, k, v, causal):
    """The wrapper's route before the kernel became the op
    `torch.ops.repro_torch.flash_attention`: its checks, then the launch
    (`ops._flash_cuda`, the op's CUDA implementation), with no dispatch."""
    for x in (q, k, v):
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(x.dtype)
    if not causal and q.shape[1] % 128:
        raise ValueError("non-causal flash requires S % 128 == 0")
    return ops._flash_cuda(q, k, v, causal)


def _flash_host_us(ops, gen, dev, calls=2000):
    """The host's microseconds a call, through the op and through the
    launch alone (`_flash_launch`), at (1, 128, 64) bf16 where the host
    sets the pace; in turns launch, op, op, launch."""
    q, k, v = (torch.randn((1, 128, 64), generator=gen, device=dev
                           ).to(torch.bfloat16) for _ in range(3))
    routes = {"launch": lambda: _flash_launch(ops, q, k, v, True),
              "op": lambda: ops.flash_attention(q, k, v, causal=True)}
    out = {"launch": [], "op": []}
    for name in ("launch", "op", "op", "launch"):
        for _ in range(50):
            routes[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            routes[name]()
        out[name].append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    print(f"  host cost a call at (1, 128, 64) bf16: through the op "
          f"{out['op'][0]:.2f} / {out['op'][1]:.2f} us, the launch alone "
          f"(the route before the op) {out['launch'][0]:.2f} / "
          f"{out['launch'][1]:.2f} us")
    return out


def _device_busy_ms(fn, top=0):
    """(host wall ms, device busy ms) of one fn() under torch.profiler:
    busy is the union of the card's kernel, copy and fill intervals in
    the trace, None if the trace holds no device event.  The profiler's
    own host cost inflates the wall time, so the idle share it gives is
    an upper bound.  Third, the `top` operators with the most device
    time of their own, as (name, calls, ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    busy = busy / 1e3 if spans else None

    def own(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    ops = [(e.key, e.count, own(e) / 1e3) for e in sorted(
        prof.key_averages(), key=own, reverse=True)[:top]]
    # the trace's events hold reference cycles (~33 objects an operator):
    # left to the collector, phase 12's ~700k of them made a 1.3 s
    # generation-2 pause inside phase 14's serving window
    del prof, spans
    gc.collect()
    return wall, busy, ops


def _nbytes(tree) -> int:
    """Bytes of the tensors among a pytree's leaves."""
    from torch.utils._pytree import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _counted_call(fn, arg_bytes: int) -> dict:
    """FLOPs of one fn() under `FlopCounterMode`, and its peak memory: the
    card's `max_memory_allocated` over the call less what was resident
    beside its arguments (`arg_bytes`) before it - the figure the dry
    run's trace gives as its peak."""
    from torch.utils.flop_counter import FlopCounterMode
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - arg_bytes
    torch.cuda.reset_peak_memory_stats()
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - resident
    del out
    return dict(flops=float(counter.get_total_flops()), peak_bytes=peak)


def _lm_phase(dev):
    """Phase 12: the language-model serving path at glm4-9b's full width
    and depth (40 layers, d_model 4096, 32 heads, 2 KV heads, head_dim
    128, d_ff 13696, vocab 151552, bfloat16), weights from `init_params`
    on a CUDA generator.  `Engine(max_len=1056).generate` on a seeded (4,
    1024) prompt for 32 greedy tokens (one flash launch per layer of its
    prefill), repeated for determinism; a `ContinuousBatchingEngine` over
    4 slots serving 6 requests of mixed prompt lengths; then the full
    model's two attention routes compared in bf16 (information, not a
    gate), and a 2-layer float32 glm4-9b whose `prefill` logits through
    the kernel must match the chunked plain path within LM_ROUTE_TOL of
    max|logit|.  Returns (launches on the generate path, stats)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import transformer as tr
    from repro_torch.models.lm_engine import Engine
    from repro_torch.models.lm_scheduler import (ContinuousBatchingEngine,
                                                 Request)
    from repro_torch.models.serve_step import (make_decode_step,
                                               make_prefill_step)
    from repro_torch.tree import tree_leaves
    cfg = get_config("glm4-9b")
    print(f"phase 12: LM serving, {cfg.name} full size ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} "
          f"heads x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.param_dtype})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tr.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    n_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    print(f"  init_params: {n_params / 1e9:.3f} G parameters, "
          f"{n_bytes / 1e9:.2f} GB, {time.perf_counter() - t0:.2f} s")
    b, s, n_new, max_len = 4, 1024, 32, 1056
    prompts = torch.randint(0, cfg.vocab, (b, s), device=dev,
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(1))
    engine = Engine(cfg, params, max_len=max_len)
    engine.generate(prompts, 4)                           # warm-up
    torch.cuda.synchronize()

    flash_attention.flash_attention.launches = 0
    t0 = time.perf_counter()
    ids = engine.generate(prompts, n_new)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    launches = flash_attention.flash_attention.launches
    print(f"  Engine.generate (4, 1024) + {n_new} greedy tokens: "
          f"{gen_wall:.3f} s wall, {launches} flash launches")
    if launches != cfg.n_layers:
        _fail(f"generate launched the flash kernel {launches} times, "
              f"expected {cfg.n_layers} (one a layer of the prefill)")
    if tuple(ids.shape) != (b, n_new) or not bool(
            ((ids >= 0) & (ids < cfg.vocab)).all()):
        _fail(f"generated ids of shape {tuple(ids.shape)} outside "
              f"[0, {cfg.vocab})")
    again = engine.generate(prompts, n_new)
    if not torch.equal(ids, again):
        _fail("a second generate from the same inputs gave other ids")
    prefill_step = make_prefill_step(cfg, max_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nxt, cache = prefill_step(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if not torch.equal(nxt, ids[:, 0]):
        _fail("prefill's next token differs from generate's first id")
    decode_ms = (gen_wall - prefill_s) / n_new * 1e3
    print(f"  host clock: prefill {prefill_s * 1e3:.1f} ms "
          f"({b * s / prefill_s:.0f} tokens/s), decode {decode_ms:.2f} ms a "
          f"step of {b} tokens ({b / decode_ms * 1e3:.0f} tokens/s; "
          f"weights {n_bytes / 1e9:.2f} GB read a step: "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s)")
    decode_step = make_decode_step(cfg)

    def four_steps():
        tok, c = nxt, cache
        for i in range(4):
            tok, c = decode_step(params, c, tok, s + i, None)

    profiled = {}
    for what, fn in (("prefill", lambda: prefill_step(
            params, {"tokens": prompts})), ("4 decode steps", four_steps)):
        wall, busy, _ = _device_busy_ms(fn)
        profiled[what] = dict(wall_ms=wall, busy_ms=busy)
        print(f"  torch.profiler, {what}: {wall:.1f} ms wall, device busy "
              + ("not measured (no device events in the trace)"
                 if busy is None else
                 f"{busy:.1f} ms ({1 - busy / wall:.1%} idle)"))
    del cache
    counted = _counted_call(lambda: make_prefill_step(cfg, s)(
        params, {"tokens": prompts}), n_bytes + prompts.numel()
        * prompts.element_size())
    print(f"  one prefill (cache_len {s}) under FlopCounterMode: "
          f"{counted['flops']:.6e} FLOPs (the attention kernel's by its "
          f"registered formula), peak {counted['peak_bytes'] / 1e9:.3f} GB "
          f"(its arguments and what it allocates)")

    # continuous batching: 6 requests of mixed prompt lengths, 4 slots
    rng = np.random.default_rng(12)
    reqs = [Request(i, rng.integers(0, cfg.vocab, size=n).tolist(), m)
            for i, (n, m) in enumerate([(5, 8), (17, 4), (9, 12), (30, 6),
                                        (3, 10), (12, 5)])]
    cb = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = cb.run(reqs)
    torch.cuda.synchronize()
    cb_wall = time.perf_counter() - t0
    print(f"  ContinuousBatchingEngine: {len(reqs)} requests over 4 slots "
          f"(max_len 64) in {cb_wall:.3f} s, "
          f"{sum(len(v) for v in served.values())} tokens generated")
    for r in reqs:
        got = served.get(r.req_id, [])
        if len(got) != r.max_new or not all(0 <= t < cfg.vocab for t in got):
            _fail(f"request {r.req_id}: {len(got)} ids of {r.max_new}, or "
                  f"ids outside the vocabulary")

    # the two routes at full depth in bf16: information only
    before = flash_attention.flash_attention.launches
    kernel_logits, _ = tr.forward(params, cfg, tokens=prompts)
    plain_logits, _ = tr.forward(params, cfg, tokens=prompts,
                                 use_flash=False)
    if flash_attention.flash_attention.launches != before + cfg.n_layers:
        _fail("forward did not launch the flash kernel once a layer")
    agree = float((kernel_logits.argmax(-1) == plain_logits.argmax(-1)
                   ).double().mean())
    last = int((kernel_logits[:, -1].argmax(-1)
                == plain_logits[:, -1].argmax(-1)).sum())
    print(f"  bf16, full depth, kernel vs chunked route: argmax agrees at "
          f"{agree:.2%} of {b * s} positions, next token at {last} of {b} "
          f"(information: the routes round differently in bf16)")
    del kernel_logits, plain_logits, params, engine, cb
    torch.cuda.empty_cache()

    # 2 layers at full width in float32 (TF32 off): the routes agree
    import dataclasses
    cfg2 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                               compute_dtype="float32")
    params2 = tr.init_params(torch.Generator(device=dev).manual_seed(2),
                             cfg2)
    kernel2, _ = tr.prefill(params2, cfg2, tokens=prompts)
    plain2, _ = tr.prefill(params2, cfg2, tokens=prompts, use_flash=False)
    err = _check_close("2-layer float32 glm4-9b prefill logits, kernel vs "
                       "chunked route", kernel2, plain2, LM_ROUTE_TOL)
    del params2
    torch.cuda.empty_cache()
    return launches, dict(prefill_ms=prefill_s * 1e3, decode_ms=decode_ms,
                          prefill_flops=counted["flops"],
                          prefill_peak_bytes=counted["peak_bytes"],
                          generate_s=gen_wall, cb_s=cb_wall,
                          profiled=profiled,
                          route_err=err, bf16_agree=agree)


TRAIN_ARCH = "stablelm-1.6b"
TRAIN_SHAPE = dict(mode="train", seq_len=4096, global_batch=8,
                   microbatch=2)   # train_4k's seq_len; its batch 256 -> 8
TRAIN_STEPS = 4                    # the first is the warm-up
TRAIN_LOSS_TOL = 1e-5   # card vs host loss, float32: sums reassociated
TRAIN_GRAD_TOL = 1e-4   # card vs host gradients, of max|g| a leaf: the
#                         same, through softmax and the backward
REMAT_TOL = 1e-6        # remat "dots" / "full" vs "none" on the card, of
#                         max|g|: recomputation repeats the same ops
RESUME_TOL = 1e-6       # a resumed run's losses vs the uninterrupted run's
PRECOND_F64_TOL = 1e-3  # digital inverse root (float32 Denman-Beavers over
#                         block_inv GEMMs) vs a float64 eigh root, relative
#                         Frobenius; the bf16 gradient adds one rounding
PRECOND_ANALOG_TOL = 0.05  # analog vs digital preconditioned gradient, the
#                            reference's acceptance (test_optim_runtime.py)


def _rel_fro(x, ref):
    return float(torch.linalg.norm((x - ref).double())
                 / torch.linalg.norm(ref.double()))


def _train_flops(cfg, n_params, tokens, seq_len):
    """FLOPs of one step, as (the function's, the chunked path's).  The
    function needs 6 N a token, plus causal attention's 2 S d a token a
    layer (scores and p . v over the S / 2 keys a token sees on average)
    times 3 for its forward and backward.  The chunked path does more:
    4 S d a token a layer (all S keys, the mask applied after the
    product) times 3, plus 1 for the recomputation under remat."""
    d_attn = cfg.n_heads * cfg.head_dim
    per_layer = seq_len * d_attn * tokens * cfg.n_layers
    return (6 * n_params * tokens + 3 * 2 * per_layer,
            6 * n_params * tokens + 4 * 4 * per_layer)


def _train_phase(dev, root):
    """Phase 15: the training path on the card.  stablelm-1.6b at full
    width and depth (24 layers, d_model 2048, 32 heads x 64, d_ff 5632,
    vocab 100352, bf16 parameters, float32 moments), random weights from
    a generator seeded 0 on the card, trained by `Trainer.run` for
    `steps` steps of (8, 4096) tokens from `SyntheticLM(seed=0)`, 4
    microbatches of 2, remat "dots": losses finite, no attention-kernel
    launch (the training route is the chunked path), step wall,
    tokens/s, peak memory, busy share and the share of the step's bound.
    Then the BlockAMC preconditioner on the embedding's gradient (one
    microbatch of the trained model): digital and analog refreshes at the
    reference's defaults, the digital inverse root against float64 and
    the analog against the digital; a 2-layer float32 stablelm at full
    width, its gradients and one `make_train_step` on the card against
    the host, remat "dots" and "full" against "none"; and a trainer
    resume on the card at `host_scale_config`.  Returns the phase's
    stats."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import blockamc
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.hybrid import AnalogPreconditioner
    from repro_torch.kernels import arena_mvm, flash_attention
    from repro_torch.launch.train import host_scale_config
    from repro_torch.models import transformer as tr
    from repro_torch.numerics import over
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.blockamc_precond import BlockAMCPrecond
    from repro_torch.train.train_step import (TrainState, make_train_step,
                                              value_and_grad)
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config(TRAIN_ARCH)
    run = RunConfig(model=cfg, **TRAIN_SHAPE)
    steps = TRAIN_STEPS
    tokens = run.global_batch * run.seq_len
    print(f"phase 15: training, {cfg.name} full size ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} "
          f"heads x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.param_dtype} parameters, {run.moments_dtype} moments); "
          f"({run.global_batch}, {run.seq_len}) tokens a step in "
          f"{run.global_batch // run.microbatch} microbatches of "
          f"{run.microbatch}, remat {run.remat!r}")
    flash_attention.flash_attention.launches = 0
    arena_mvm.arena_packed_apply.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, run, seed=0, device=dev)
    torch.cuda.synchronize()
    leaves = list(tree_leaves(trainer.state.params))
    n_params = sum(x.numel() for x in leaves)
    print(f"  Trainer: {n_params / 1e9:.4f} G parameters, "
          f"{sum(x.numel() * x.element_size() for x in leaves) / 1e9:.2f} "
          f"GB, state ready in {time.perf_counter() - t0:.2f} s")
    hist = trainer.run(steps)
    for i, (loss, dt) in enumerate(zip(hist["loss"], hist["dt"])):
        print(f"  step {i}: loss {loss:.6f}, {dt:.4f} s (host clock)"
              + (" warm-up" if i == 0 else ""))
    if not all(np.isfinite(hist["loss"])):
        _fail(f"non-finite training losses {hist['loss']}")
    step_s = statistics.median(hist["dt"][1:])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = trainer.data.batch(steps)

    def one_step():
        trainer.state, metrics = trainer.step_fn(trainer.state, batch)
        float(metrics["loss"])
    wall_ms, busy_ms, top_ops = _device_busy_ms(one_step, top=10)
    counted = _counted_call(lambda: trainer.step_fn(trainer.state, batch),
                            _nbytes((trainer.state, batch)))
    print(f"  one more step under FlopCounterMode (not in the median): "
          f"{counted['flops']:.6e} FLOPs, peak "
          f"{counted['peak_bytes'] / 1e9:.3f} GB (its arguments and what "
          f"it allocates)")
    flops, chunked_flops = _train_flops(cfg, n_params, tokens, run.seq_len)
    bound_s = flops / BF16_FLOP_PER_S
    chunked_s = chunked_flops / BF16_FLOP_PER_S
    train_flash = flash_attention.flash_attention.launches
    train_arena = arena_mvm.arena_packed_apply.launches
    print(f"  steady step {step_s:.4f} s (median of steps 1-{steps - 1}), "
          f"{tokens / step_s:.0f} tokens/s; peak memory "
          f"{peak_gb:.2f} GB (max_memory_allocated)")
    print(f"  torch.profiler, one step: {wall_ms:.1f} ms wall, device busy "
          + ("not measured (no device events in the trace)"
             if busy_ms is None else
             f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%} busy)"))
    for name, calls, ms in top_ops:
        print(f"    {ms:10.1f} ms device, {calls:6d} calls  {name}")
    print(f"  bound: {flops:.4e} FLOPs (6 N a token + causal attention "
          f"6 S d a token a layer) at 989 TFLOP/s bf16 = {bound_s:.4f} s; "
          f"the step reaches {bound_s / step_s:.1%} of it.  The chunked "
          f"path's own work: {chunked_flops:.4e} FLOPs (attention 16 S d: "
          f"all S keys, x3, +1 recomputed) = {chunked_s:.4f} s, "
          f"{chunked_s / step_s:.1%} of the step")
    print(f"  attention-kernel launches in the phase: {train_flash}; arena "
          f"launches: {train_arena}")
    if train_flash != 0:
        _fail(f"training launched the flash kernel {train_flash} times: "
              f"the route under autograd is the chunked path")
    if train_arena != 0:
        _fail(f"training launched the arena kernel {train_arena} times: "
              f"the trainer runs no solver")

    # -- the BlockAMC preconditioner on the embedding's gradient ----------
    micro = {k: v[:run.microbatch] for k, v in trainer.data.batch(0).items()}
    _, _, grads = value_and_grad(trainer.state.params, micro, cfg,
                                 run.remat)
    g = grads["embed"]
    del grads, trainer, batch, micro, leaves
    torch.cuda.empty_cache()
    pre_d = BlockAMCPrecond()
    pre_a = BlockAMCPrecond(use_analog=True)
    stats0 = pre_d.update_stats({"embed": g}, pre_d.init({"embed": g}))
    gram = stats0.gram["embed"]
    d = gram.shape[0]
    print(f"  BlockAMCPrecond on the embedding's gradient {tuple(g.shape)} "
          f"{str(g.dtype).split('.')[-1]}: Gram {d}x{d}, damping "
          f"{pre_d.damping}, leaf {pre_d.leaf_size}, {pre_d.db_iters} "
          f"Denman-Beavers iterations ({2 * pre_d.db_iters} inverses)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_d = pre_d.refresh_inverses(stats0)
    torch.cuda.synchronize()
    digital_s = time.perf_counter() - t0
    a64 = gram.double() + pre_d.damping * torch.eye(
        d, dtype=torch.float64, device=dev)
    evals, evecs = torch.linalg.eigh(a64)
    root64 = (evecs * evals.rsqrt()) @ evecs.T
    inv_err = _rel_fro(st_d.inv["embed"], root64)
    out_d = pre_d.precondition({"embed": g}, st_d)["embed"]
    out_err = _rel_fro(out_d, g.double() @ root64)
    print(f"  digital refresh: {digital_s:.3f} s; G + lambda I: eigenvalues "
          f"{float(evals.min()):.4e}..{float(evals.max()):.4e} (cond "
          f"{float(evals.max() / evals.min()):.3e}); inverse root vs "
          f"float64 eigh {inv_err:.3e}, preconditioned gradient "
          f"({str(out_d.dtype).split('.')[-1]}) {out_err:.3e} (relative "
          f"Frobenius; tolerance {PRECOND_F64_TOL:g} on the root)")
    if not inv_err < PRECOND_F64_TOL:
        _fail(f"digital inverse root {inv_err:.3e} from float64")
    # a program of the refresh's first matrix, (G + lambda I) / c: its seed
    # precond(eye) through the kernel (one launch) against the plain path
    # on the same arena plan and against the finalized schedule, before
    # any CG - at cond ~1 four CG iterations would hide a wrong seed
    probe = pre_a.analog_cfg
    a0 = gram + pre_a.damping * torch.eye(d, dtype=torch.float32, device=dev)
    a0 = a0 / over(torch.trace(a0), d)
    solver = blockamc.ProgrammedSolver.program(
        a0, torch.Generator().manual_seed(0), probe, device=dev)
    ap = solver.arena
    n_tiles, n_terms = ap.program[1].shape
    instance = arena_mvm.device_plan(dev, 1, ap.arena_size, d, n_tiles,
                                     probe.array_size, n_terms)
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    arena_mvm.arena_packed_apply.launches = 0
    seed = AnalogPreconditioner.from_solver(solver)(eye)
    seed_launches = arena_mvm.arena_packed_apply.launches
    if seed_launches != 1:
        _fail(f"precond(eye) launched the arena kernel {seed_launches} times")
    seed_err = _check_close(
        f"precond(eye) at T={n_tiles}, K={d}: kernel vs plain arena path",
        seed, blockamc.execute_arena(ap, eye, use_kernel=False).T,
        KERNEL_REL_TOL)      # row j of precond(eye) answers column j
    _check_close("precond(eye): kernel vs the finalized schedule",
                 seed, AnalogPreconditioner(solver.finalized,
                                            mode="reference")(eye),
                 SOLVE_REL_TOL)
    del solver, seed, eye, a0
    arena_mvm.arena_packed_apply.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_a = pre_a.refresh_inverses(stats0)
    torch.cuda.synchronize()
    analog_s = time.perf_counter() - t0
    analog_launches = arena_mvm.arena_packed_apply.launches
    out_a = pre_a.precondition({"embed": g}, st_a)["embed"]
    analog_err = _rel_fro(out_a, out_d)
    print(f"  analog refresh (use_analog=True, {probe.array_size}x"
          f"{probe.array_size} arrays, refine_iters {pre_a.refine_iters}): "
          f"{analog_s:.3f} s, {analog_launches} arena launches; each "
          f"program T={n_tiles} tiles, J={n_terms}, arena {ap.arena_size} "
          f"rows, K={d} columns, instance {instance}; vs digital "
          f"{analog_err:.3e} (tolerance {PRECOND_ANALOG_TOL:g})")
    if analog_launches != 2 * pre_a.db_iters:
        _fail(f"the analog refresh launched the arena kernel "
              f"{analog_launches} times, expected {2 * pre_a.db_iters} "
              f"(one a program)")
    if not analog_err < PRECOND_ANALOG_TOL:
        _fail(f"analog preconditioned gradient {analog_err:.3e} from the "
              f"digital one")
    del g, st_d, st_a, stats0, out_d, out_a, root64, a64, evecs
    torch.cuda.empty_cache()

    # -- 2 layers at full width in float32: the card against the host -----
    cfg2 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                               compute_dtype="float32")
    run2 = RunConfig(model=cfg2, mode="train", seq_len=256, global_batch=2)
    host = tr.init_params(torch.Generator().manual_seed(2), cfg2)
    card = tree_map(lambda x: x.to(dev), host)
    batch_h = SyntheticLM(cfg2, run2, seed=1, device="cpu").batch(0)
    batch_c = {k: v.to(dev) for k, v in batch_h.items()}
    t0 = time.perf_counter()
    loss_c, _, g_c = value_and_grad(card, batch_c, cfg2, run2.remat)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_h, _, g_h = value_and_grad(host, batch_h, cfg2, run2.remat)
    host_s = time.perf_counter() - t0
    loss_err = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))

    def worst(got, want):     # the worst leaf's error, of its max|want|
        return max(_max_err(a.cpu(), b.cpu())[1]
                   for a, b in zip(tree_leaves(got), tree_leaves(want)))
    grad_err = worst(g_c, g_h)
    print(f"  2-layer float32 {cfg2.name} (d_model {cfg2.d_model}), (2, 256) "
          f"tokens, card vs host: loss {float(loss_c):.6f} vs "
          f"{float(loss_h):.6f} ({loss_err:.2e} relative, tolerance "
          f"{TRAIN_LOSS_TOL:g}); worst gradient leaf {grad_err:.2e} of its "
          f"max|g| (tolerance {TRAIN_GRAD_TOL:g}); {card_s:.2f} s on the "
          f"card, {host_s:.2f} s on the host")
    if not loss_err <= TRAIN_LOSS_TOL:
        _fail(f"card loss {loss_err:.2e} from the host's")
    if not grad_err <= TRAIN_GRAD_TOL:
        _fail(f"card gradients {grad_err:.2e} of max|g| from the host's")
    remat_err = {}
    g_none = value_and_grad(card, batch_c, cfg2, "none")[2]
    for remat in ("dots", "full"):
        g_r = g_c if remat == run2.remat else \
            value_and_grad(card, batch_c, cfg2, remat)[2]
        remat_err[remat] = worst(g_r, g_none)
    print(f"  remat vs \"none\" on the card, worst leaf of max|g|: "
          + ", ".join(f"{r} {e:.2e}" for r, e in remat_err.items())
          + f" (tolerance {REMAT_TOL:g})")
    if not max(remat_err.values()) <= REMAT_TOL:
        _fail(f"remat changed the gradients: {remat_err}")
    del g_c, g_h, g_none
    opt = AdamW(lr=run2.learning_rate)
    step2 = make_train_step(cfg2, run2, opt)
    metrics = {}
    for where, params, b in (("card", card, batch_c), ("host", host,
                                                       batch_h)):
        _, m = step2(TrainState(params, opt.init(params)), b)
        metrics[where] = {k: float(v) for k, v in m.items()}
    step_err = abs(metrics["card"]["loss"] - metrics["host"]["loss"]) / abs(
        metrics["host"]["loss"])
    print(f"  make_train_step, card vs host: loss {step_err:.2e} relative, "
          f"grad_norm {metrics['card']['grad_norm']:.6f} vs "
          f"{metrics['host']['grad_norm']:.6f}")
    if not step_err <= TRAIN_LOSS_TOL:
        _fail(f"the card's train step loss {step_err:.2e} from the host's")
    del card, host
    torch.cuda.empty_cache()

    # -- a resume on the card at host scale --------------------------------
    hcfg = host_scale_config(cfg)
    hrun = RunConfig(model=hcfg, mode="train", seq_len=128, global_batch=8)
    whole = Trainer(hcfg, hrun, device=dev).run(4)["loss"]
    scratch = root / "artifacts"
    scratch.mkdir(exist_ok=True)
    import tempfile
    with tempfile.TemporaryDirectory(dir=scratch) as ckpt_dir:
        Trainer(hcfg, hrun, ckpt_dir=ckpt_dir, ckpt_every=2,
                device=dev).run(2)
        again = Trainer(hcfg, hrun, ckpt_dir=ckpt_dir, ckpt_every=2,
                        device=dev)
        start = again.start_step
        resumed = again.run(2)["loss"]
    resume_err = max(abs(a - b) / abs(b) for a, b in zip(resumed, whole[2:]))
    print(f"  resume at host scale ({hcfg.n_layers} layers, d_model "
          f"{hcfg.d_model}): saved at step 2, resumed at {start}; steps 3-4 "
          f"{resumed} vs uninterrupted {whole[2:]} ({resume_err:.2e}, "
          f"tolerance {RESUME_TOL:g})")
    if start != 2 or not resume_err <= RESUME_TOL:
        _fail("the resumed run does not reproduce the uninterrupted one")
    return dict(losses=hist["loss"], step_dt=hist["dt"], step_s=step_s,
                tokens_per_s=tokens / step_s, peak_gb=peak_gb,
                counted_flops=counted["flops"],
                counted_peak_bytes=counted["peak_bytes"],
                profiled_wall_ms=wall_ms, busy_ms=busy_ms, top_ops=top_ops,
                flops=flops, chunked_flops=chunked_flops,
                bound_s=bound_s, bound_share=bound_s / step_s,
                flash_launches=train_flash, arena_launches=train_arena,
                precond=dict(
                    digital_s=digital_s, analog_s=analog_s,
                    analog_launches=analog_launches, seed_err=seed_err,
                    inv_err=inv_err,
                    out_err=out_err, analog_err=analog_err, d=d,
                    cond=float(evals.max() / evals.min()),
                    tiles=n_tiles, instance=instance),
                card_vs_host=dict(loss_err=loss_err, grad_err=grad_err,
                                  step_loss_err=step_err,
                                  remat_err=remat_err),
                resume_err=resume_err)


MC_SIMS = 40            # the paper's "40 random simulations" (Fig. 7)
MC_REFINED_TOL = 1e-6   # refined sweep, sharded vs unsharded, of max|x|:
#                         both converge to a 1e-10 residual in float64


def _mc_mesh_phase(dev):
    """Phase 16: the Monte-Carlo mesh on the card - a one-rank NCCL group
    (`launch.mesh.make_mc_mesh`) under the three `*_sharded` solvers:
    Fig. 7's sweep at its largest size (`benchmarks/fig7_variation.py`:
    n=512 Wishart, one stage, 256x256 arrays, sigma=0.05, 40 simulations)
    through `solve_batched_sharded(mode="fused")`, one arena launch, held
    to `solve_batched` on the same generators; Fig. 8's packed fleet
    (n=256, two stages, 64x64, 16 tenants x 8 rhs) through
    `execute_arena_packed_sharded`, one launch, held to
    `execute_arena_packed`; `solve_refined_batched_sharded` on 8 keys at
    n=256 (float64 GMRES, tol 1e-10), every column converged, held to
    `solve_refined_batched`.  The group is destroyed at the end.
    Returns the arena launches of each sharded call."""
    import torch.distributed as dist
    from repro_torch.core import blockamc
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.metrics import relative_error
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.data.matrices import random_rhs, wishart
    from repro_torch.hybrid import (solve_refined_batched,
                                    solve_refined_batched_sharded)
    from repro_torch.kernels import arena_mvm
    from repro_torch.launch.mesh import make_mc_mesh
    if dist.is_initialized():
        _fail("a process group exists before phase 16")
    mesh = make_mc_mesh(device=dev)
    print(f"phase 16: the Monte-Carlo mesh on a one-rank "
          f"{dist.get_backend()} group, mesh {mesh}")
    launches = {}

    def sharded(what, fn):
        """fn() with the arena counter set to 0 just before, read after."""
        arena_mvm.arena_packed_apply.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[what] = arena_mvm.arena_packed_apply.launches
        return out, wall

    data = torch.Generator().manual_seed(77)
    n = 512
    cfg = AnalogConfig(array_size=256, nonideal=NonidealConfig(sigma=0.05))
    a, b = wishart(data, n, device=dev), random_rhs(data, n, device=dev)

    def gens():
        return [torch.Generator().manual_seed(100 + i)
                for i in range(MC_SIMS)]
    xs, wall = sharded("Fig. 7 sweep", lambda: blockamc.solve_batched_sharded(
        a, b, gens(), cfg, stages=1, mesh=mesh, mode="fused"))
    want = blockamc.solve_batched(a, b, gens(), cfg, stages=1, mode="fused")
    err = _check_close(f"Fig. 7 sweep (n={n}, 256x256, one stage, "
                       f"{MC_SIMS} simulations) sharded vs solve_batched",
                       xs, want, SOLVE_REL_TOL)
    paper = relative_error(torch.linalg.solve(a.double(), b.double()),
                           xs.double())
    print(f"  solve_batched_sharded: {launches['Fig. 7 sweep']} arena "
          f"launches, {wall:.3f} s host wall (programming included); "
          f"median paper metric {float(paper.median()):.4f} over "
          f"{MC_SIMS} simulations")
    if tuple(xs.shape) != (MC_SIMS, n) or launches["Fig. 7 sweep"] != 1:
        _fail(f"the sharded sweep gave shape {tuple(xs.shape)} in "
              f"{launches['Fig. 7 sweep']} launches (expected 1)")

    n, tenants, k = 256, 16, 8
    cfg = AnalogConfig(array_size=64, nonideal=NonidealConfig(sigma=0.05))
    As = torch.stack([wishart(data, n, device=dev) for _ in range(tenants)])
    pp = blockamc.program_packed(
        As, [torch.Generator().manual_seed(i) for i in range(tenants)], cfg,
        2, device=dev)
    bs = torch.stack([torch.stack([random_rhs(data, n, device=dev)
                                   for _ in range(k)], dim=1)
                      for _ in range(tenants)])
    xs, wall = sharded("packed fleet", lambda:
                       blockamc.execute_arena_packed_sharded(pp, bs,
                                                             mesh=mesh))
    _check_close("packed fleet (16 tenants x 8 rhs) sharded vs "
                 "execute_arena_packed", xs,
                 blockamc.execute_arena_packed(pp, bs), SOLVE_REL_TOL)
    print(f"  execute_arena_packed_sharded: {launches['packed fleet']} "
          f"arena launches, {wall * 1e3:.3f} ms host wall (first call)")
    if launches["packed fleet"] != 1:
        _fail(f"the sharded fleet launched {launches['packed fleet']} times")

    a = wishart(data, n, device=dev).double()
    b = torch.stack([random_rhs(data, n, device=dev) for _ in range(4)],
                    dim=1).double()
    kw = dict(stages=2, method="gmres", tol=1e-10, maxiter=400, restart=32,
              device=dev)

    def keys():
        return [torch.Generator().manual_seed(200 + i) for i in range(8)]
    res, wall = sharded("refined sweep", lambda: solve_refined_batched_sharded(
        a, b, keys(), cfg, mesh=mesh, **kw))
    one = solve_refined_batched(a, b, keys(), cfg, **kw)
    err_r = _check_close("refined sweep (8 keys, n=256) sharded vs "
                         "solve_refined_batched", res.x, one.x,
                         MC_REFINED_TOL)
    print(f"  solve_refined_batched_sharded: {launches['refined sweep']} "
          f"arena launches, {wall:.3f} s host wall; GMRES iterations "
          f"{int(res.iters.min())}-{int(res.iters.max())} (unsharded "
          f"{int(one.iters.min())}-{int(one.iters.max())}), worst residual "
          f"{float(res.resnorm.max()):.2e}")
    if not bool(res.converged.all()):
        _fail("the sharded refined sweep did not converge on every column")
    dist.destroy_process_group()
    return launches, dict(sweep_err=err, refined_err=err_r)


LM_SERVED = (          # (arch, layers kept, batch, prompt, new tokens)
    ("recurrentgemma-2b", None, 2, 3072, 32),   # prompt > local_window 2048
    ("mamba2-130m", None, 4, 1024, 32),         # phase 12's traffic
    ("phi3.5-moe-42b-a6.6b", 16, 4, 1024, 32),  # all 32 do not fit 80 GB
)


def _serve_lm(dev, smi, arch, layers, b, s, n_new):
    """Serve one model at full width on the card with seeded random
    weights: `Engine.generate` of n_new greedy tokens after a (b, s)
    prompt, prefill wall, decode ms a step, peak memory and the device's
    busy share; flash launches counted over the generate.  Returns
    (cfg, params, stats); the caller frees the parameters."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tr
    from repro_torch.models.lm_engine import Engine
    from repro_torch.models.serve_step import (make_decode_step,
                                               make_prefill_step)
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    cut = "" if layers is None else \
        f", depth cut from {cfg.n_layers} to {layers} layers"
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tr.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    n_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    print(f"  {cfg.name}: {cfg.n_layers} layers{cut}, d_model "
          f"{cfg.d_model}, pattern {tr.stack_layout(cfg)[0]}, "
          f"{n_params / 1e9:.4f} G parameters, {n_bytes / 1e9:.2f} GB "
          f"{cfg.param_dtype}, init {time.perf_counter() - t0:.2f} s")
    max_len = s + n_new
    prompts = torch.randint(0, cfg.vocab, (b, s), device=dev,
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(1))
    engine = Engine(cfg, params, max_len=max_len)
    engine.generate(prompts, 2)                           # warm-up
    torch.cuda.synchronize()
    flash_attention.flash_attention.launches = 0
    t0 = time.perf_counter()
    ids = engine.generate(prompts, n_new)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    flash = flash_attention.flash_attention.launches
    if tuple(ids.shape) != (b, n_new) or not bool(
            ((ids >= 0) & (ids < cfg.vocab)).all()):
        _fail(f"{cfg.name}: ids of shape {tuple(ids.shape)} outside "
              f"[0, {cfg.vocab})")
    prefill_step = make_prefill_step(cfg, max_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nxt, cache = prefill_step(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode_ms = (gen_wall - prefill_s) / n_new * 1e3
    dropped = None
    if cfg.n_experts:           # count the prefill's capacity drops
        counts, ffn = [], moe_mod.moe_ffn

        def counted(p, h, c):
            counts.append(moe_mod.dropped_slots(h, p, c))
            return ffn(p, h, c)
        moe_mod.moe_ffn = counted
        try:
            prefill_step(params, {"tokens": prompts})
        finally:
            moe_mod.moe_ffn = ffn
        dropped = sum(counts)
    decode_step = make_decode_step(cfg)

    def four_steps():
        tok, c = nxt, cache
        for i in range(4):
            tok, c = decode_step(params, c, tok, s + i, None)
    busy = {}
    for what, fn in (("prefill", lambda: prefill_step(
            params, {"tokens": prompts})), ("4 decode steps", four_steps)):
        wall, dev_ms, _ = _device_busy_ms(fn)
        busy[what] = None if dev_ms is None else dev_ms / wall
    del cache
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def share(x):
        return "not measured" if x is None else f"{x:.1%}"
    print(f"    generate ({b}, {s}) + {n_new} greedy tokens: {gen_wall:.3f} "
          f"s; prefill {prefill_s * 1e3:.1f} ms ({b * s / prefill_s:.0f} "
          f"tokens/s), decode {decode_ms:.2f} ms a step of {b} tokens; "
          f"peak {peak_gb:.2f} GB; busy {share(busy['prefill'])} of the "
          f"prefill, {share(busy['4 decode steps'])} of 4 decode steps; "
          f"{flash} flash launches"
          + ("" if dropped is None else
             f"; {dropped} (token, expert) slots of "
             f"{b * s * cfg.top_k * cfg.n_layers} dropped by capacity in "
             f"the prefill") + f" ({smi})")
    return cfg, params, dict(params_g=n_params / 1e9, gen_s=gen_wall,
                             prefill_ms=prefill_s * 1e3,
                             decode_ms=decode_ms, peak_gb=peak_gb,
                             busy=busy, flash_launches=flash,
                             dropped=dropped, layers=cfg.n_layers)


def _lm_families_phase(dev, smi):
    """Phase 17: the MoE, RG-LRU and SSD model families on the card, each
    with seeded random weights, the previous model freed first:
    recurrentgemma-2b at full width and depth serving a 3072-token prompt
    (past its 2048-token window: the ring wraps; the window takes the
    chunked path, so no flash launch); mamba2-130m at full size serving
    phase 12's traffic and training 4 steps of (8, 4096) tokens in
    microbatches of 2 with remat "dots", and a 2-layer float32 mamba2
    card against host; phi3.5-moe at full width, 16 of its 32 layers,
    serving phase 12's traffic with one flash launch a layer of the
    prefill, and a 2-layer float32 route check.  Returns the stats."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention
    from repro_torch.models import transformer as tr
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves, tree_map
    print(f"phase 17: the MoE, RG-LRU and SSD families on the card ({smi})")
    stats = {}
    for arch, layers, b, s, n_new in LM_SERVED:
        cfg, params, st = _serve_lm(dev, smi, arch, layers, b, s, n_new)
        stats[arch] = st
        want = cfg.n_layers if cfg.n_experts else 0
        if st["flash_launches"] != want:
            _fail(f"{arch}: {st['flash_launches']} flash launches in "
                  f"generate, expected {want}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        if arch == "mamba2-130m":
            run = RunConfig(model=cfg, **TRAIN_SHAPE)
            torch.cuda.reset_peak_memory_stats()
            flash_attention.flash_attention.launches = 0
            trainer = Trainer(cfg, run, seed=0, device=dev)
            hist = trainer.run(TRAIN_STEPS)
            step_s = statistics.median(hist["dt"][1:])
            tokens = run.global_batch * run.seq_len
            peak = torch.cuda.max_memory_allocated() / 1e9
            print(f"    trained {TRAIN_STEPS} steps of ({run.global_batch}, "
                  f"{run.seq_len}) tokens, microbatches of "
                  f"{run.microbatch}, remat {run.remat!r}: losses "
                  f"{[round(x, 6) for x in hist['loss']]}, steady step "
                  f"{step_s:.4f} s ({tokens / step_s:.0f} tokens/s), peak "
                  f"{peak:.2f} GB ({smi})")
            if not all(np.isfinite(hist["loss"])):
                _fail(f"mamba2 training losses {hist['loss']}")
            st.update(train_losses=hist["loss"], train_step_s=step_s,
                      train_tokens_per_s=tokens / step_s,
                      train_peak_gb=peak)
            del trainer
            torch.cuda.empty_cache()
            cfg2 = dataclasses.replace(cfg, n_layers=2,
                                       param_dtype="float32",
                                       compute_dtype="float32")
            run2 = RunConfig(model=cfg2, mode="train", seq_len=256,
                             global_batch=2)
            host = tr.init_params(torch.Generator().manual_seed(2), cfg2)
            card = tree_map(lambda x: x.to(dev), host)
            batch_h = SyntheticLM(cfg2, run2, seed=1, device="cpu").batch(0)
            batch_c = {k: v.to(dev) for k, v in batch_h.items()}
            loss_c, _, g_c = value_and_grad(card, batch_c, cfg2, run2.remat)
            loss_h, _, g_h = value_and_grad(host, batch_h, cfg2, run2.remat)
            loss_err = abs(float(loss_c) - float(loss_h)) / abs(
                float(loss_h))
            grad_err = max(_max_err(x.cpu(), y.cpu())[1] for x, y in zip(
                tree_leaves(g_c), tree_leaves(g_h)))
            print(f"    2-layer float32 mamba2, (2, 256) tokens, card vs "
                  f"host: loss {loss_err:.2e} relative (tolerance "
                  f"{TRAIN_LOSS_TOL:g}), worst gradient leaf {grad_err:.2e} "
                  f"of its max|g| (tolerance {TRAIN_GRAD_TOL:g})")
            if not (loss_err <= TRAIN_LOSS_TOL
                    and grad_err <= TRAIN_GRAD_TOL):
                _fail("mamba2: the card's loss or gradients differ from "
                      "the host's")
            st.update(loss_err=loss_err, grad_err=grad_err)
            del card, host, g_c, g_h
        if cfg.n_experts:
            cfg2 = dataclasses.replace(cfg, n_layers=2,
                                       param_dtype="float32",
                                       compute_dtype="float32")
            params2 = tr.init_params(
                torch.Generator(device=dev).manual_seed(2), cfg2)
            prompts = torch.randint(0, cfg.vocab, (b, s), device=dev,
                                    generator=torch.Generator(
                                        device=dev).manual_seed(1))
            kernel2, _ = tr.prefill(params2, cfg2, tokens=prompts)
            plain2, _ = tr.prefill(params2, cfg2, tokens=prompts,
                                   use_flash=False)
            st["route_err"] = _check_close(
                f"2-layer float32 {cfg.name} prefill logits, kernel vs "
                f"chunked route", kernel2, plain2, LM_ROUTE_TOL)
            del params2, kernel2, plain2
        gc.collect()
        torch.cuda.empty_cache()
    return stats


MESH_TRAIN_LAYERS = 4    # stablelm-1.6b's 24 layers cut to 4 for phase 18
MESH_TRAIN_SHAPE = dict(mode="train", seq_len=4096, global_batch=4,
                        microbatch=2, remat="dots", fsdp=True)
MESH_LOGIT_TOL = 2e-4    # sharded vs unsharded prefill logits, of
#                          max|logit| (phase 12's route tolerance)
MESH_LOSS_TOL = 1e-5     # sharded vs unsharded step loss, relative
MESH_STATE_TOL = 1e-4    # sharded vs unsharded state (parameters, Adam
#                          moments) after a step, of each leaf's max|x|


def _lm_mesh_phase(dev, smi, lm_stats):
    """Phase 18: the language model's mesh on a one-rank NCCL group
    (`launch.mesh.make_host_mesh(1, 1)`), every tensor a DTensor:

    (a) glm4-9b at full size (bf16, phase 12's seeded weights and (4,
        1024) prompt), parameters laid out by `make_param_shardings`
        inside `policy_scope(make_policy(...))`: `tr.prefill` (one flash
        launch a layer, on each rank's local heads) against the
        unsharded prefill at the same parameters, then
        `Engine.generate` of the prefill's token and 8 greedy steps
        against the unsharded engine's ids; prefill wall, decode ms a
        step and the card's busy share beside phase 12's;
    (b) `_mesh_train`: stablelm-1.6b at full width, its 24 layers cut
        to 4, two sharded training steps against the unsharded ones
        (loss, gradient norm, every leaf of the state); the step walls
        of both;
    (c) `compressed_psum` over a one-rank "pod" axis of two of (b)'s
        parameters: the int8 quantise-dequantise, and the residual
        g32 - deq;
    (d) (b)'s state saved sharded and restored with
        `restore_checkpoint(..., sharding_tree=)`: every leaf bit for
        bit;
    (e) `pipeline_apply` on a one-rank "pp" axis against the sequential
        stack, forward and gradient.

    The group is destroyed at the end.  Returns the phase's stats."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint.ckpt import (flatten, restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tr
    from repro_torch.models.lm_engine import Engine
    from repro_torch.optim.grad_compression import (compressed_psum,
                                                    dequantize_int8,
                                                    init_error_state,
                                                    quantize_int8)
    from repro_torch.sharding import api, partition
    from repro_torch.train import pipeline
    if dist.is_initialized():
        _fail("a process group exists before phase 18")
    mesh = make_host_mesh(1, 1, device=dev)
    print(f"phase 18: the language model's mesh on a one-rank "
          f"{dist.get_backend()} group, mesh {mesh}")
    stats = {}

    # -- (a) sharded prefill and decode, glm4-9b full size ----------------
    cfg = get_config("glm4-9b")
    run = RunConfig(model=cfg, mode="prefill", seq_len=1024, global_batch=4)
    params = tr.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    b, s, n_new, max_len = 4, 1024, 8, 1056
    prompts = torch.randint(0, cfg.vocab, (b, s), device=dev,
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(1))
    with torch.no_grad():
        want, _ = tr.prefill(params, cfg, tokens=prompts)
    want_ids = Engine(cfg, params, max_len=max_len).generate(prompts, n_new)
    policy = partition.make_policy(mesh, cfg, run)
    with api.policy_scope(policy), torch.no_grad():
        placed = partition.distribute(params, partition.make_param_shardings(
            params, mesh, run.fsdp))
        tok = partition.distribute(prompts, partition.batch_sharding(
            mesh, cfg, run))
        tr.prefill(placed, cfg, tokens=tok)                 # warm-up
        torch.cuda.synchronize()
        flash_attention.flash_attention.launches = 0
        t0 = time.perf_counter()
        got, _ = tr.prefill(placed, cfg, tokens=tok)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = flash_attention.flash_attention.launches
        kind = type(got).__name__
        got = api.whole(got)
        engine = Engine(cfg, placed, max_len=max_len)
        engine.generate(tok, 2)                             # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = engine.generate(tok, n_new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        decode_ms = (gen_s * 1e3 - prefill_ms) / n_new
        busy = {}
        for what, fn in (("prefill", lambda: tr.prefill(placed, cfg,
                                                        tokens=tok)),
                         ("generate", lambda: engine.generate(tok, n_new))):
            wall, dev_ms, _ = _device_busy_ms(fn)
            busy[what] = dict(wall_ms=wall, busy_ms=dev_ms)
    print(f"  (a) glm4-9b, {kind} parameters and activations: prefill "
          f"(4, 1024) {launches} flash launches")
    if launches != cfg.n_layers:
        _fail(f"the sharded prefill launched the flash kernel {launches} "
              f"times, expected {cfg.n_layers}")
    err = _check_close("sharded vs unsharded prefill logits", got, want,
                       MESH_LOGIT_TOL)
    same_ids = bool(torch.equal(ids, want_ids))
    print(f"  greedy ids (prefill + {n_new - 1} decode steps) equal the "
          f"unsharded engine's: {same_ids}")
    if not same_ids:
        _fail("the sharded engine's greedy ids differ from the unsharded")
    p12 = lm_stats["profiled"]

    def share(d):
        return ("not measured" if d["busy_ms"] is None else
                f"{d['busy_ms'] / d['wall_ms']:.1%} busy")
    print(f"  host clock ({smi}): prefill {prefill_ms:.1f} ms (phase 12: "
          f"{lm_stats['prefill_ms']:.1f}), decode {decode_ms:.2f} ms a step "
          f"(phase 12: {lm_stats['decode_ms']:.2f}); torch.profiler: "
          f"prefill {share(busy['prefill'])} (phase 12: "
          f"{share(p12['prefill'])}), generate {share(busy['generate'])} "
          f"(phase 12's 4 decode steps: {share(p12['4 decode steps'])})")
    stats["a"] = dict(flash_launches=launches, logit_err=err,
                      ids_equal=same_ids, prefill_ms=prefill_ms,
                      decode_ms=decode_ms, profiled=busy)
    del params, placed, engine, got, want
    torch.cuda.empty_cache()

    # -- (b) sharded training step, stablelm-1.6b at 4 layers ------------
    st, state, new, run = _mesh_train(dev, smi, mesh)
    stats["b"] = st

    # -- (c) compressed_psum over a one-rank "pod" axis ------------------
    pods = init_device_mesh(dev.type, (1,), mesh_dim_names=("pod",))
    grads = {"embed": api.whole(new.params["embed"]),
             "wq": api.whole(new.params["blocks"]["b0"]["mix"]["wq"])}
    total, resid = compressed_psum(grads, pods, "pod",
                                   init_error_state(grads))
    for key, g in grads.items():
        q, sc = quantize_int8(g.to(torch.float32))
        deq = dequantize_int8(q, sc)
        if not (torch.equal(total[key], deq) and torch.equal(
                resid[key], g.to(torch.float32) - deq)):
            _fail(f"compressed_psum over one rank is not quantise-"
                  f"dequantise for {key}")
    print(f"  (c) compressed_psum over a one-rank 'pod' axis: "
          f"{', '.join(f'{k} {tuple(v.shape)}' for k, v in grads.items())}"
          f" equal quantise-dequantise, residuals g32 - deq")
    del grads, total, resid

    # -- (d) sharded save, sharding_tree restore -------------------------
    where = tempfile.mkdtemp(prefix="phase18_")
    try:
        t0 = time.perf_counter()
        save_checkpoint(where, 2, new)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = restore_checkpoint(where, 2, state, sharding_tree=(
            partition.make_state_shardings(state, mesh, run.fsdp)))
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(where, ignore_errors=True)
    n_leaves = 0
    for (key, a), (_, w) in zip(flatten(back), flatten(new)):
        n_leaves += 1
        if not (api.is_dtensor(a) and a.placements == w.placements
                and torch.equal(a.full_tensor(), w.full_tensor())):
            _fail(f"restored leaf {key} differs from the saved state")
    print(f"  (d) sharded save {save_s:.2f} s, restore with sharding_tree "
          f"{restore_s:.2f} s: {n_leaves} leaves bit for bit, placements "
          f"kept")
    stats["d"] = dict(save_s=save_s, restore_s=restore_s, leaves=n_leaves)
    del state, new, back
    torch.cuda.empty_cache()

    # -- (e) pipeline_apply on a one-rank "pp" axis ----------------------
    pp = init_device_mesh(dev.type, (1,), mesh_dim_names=("pp",))
    g = torch.Generator(device=dev).manual_seed(5)
    w = (torch.randn((8, 16, 16), generator=g, device=dev) * 0.125)
    x = torch.randn((8, 2, 16), generator=g, device=dev)

    def stack(p, h):
        for wi in p:
            h = torch.tanh(h @ wi)
        return h
    wp, ws = w.clone().requires_grad_(), w.clone().requires_grad_()
    outs = pipeline.pipeline_apply(stack, wp, x, pp, "pp")
    (outs ** 2).sum().backward()
    seq = stack(ws, x)
    (seq ** 2).sum().backward()
    f_err = _check_close("one-stage pipeline vs the stack", outs.detach(),
                         seq.detach(), 2e-5)
    g_err = _check_close("one-stage pipeline gradient vs the stack's",
                         wp.grad, ws.grad, 2e-4)
    stats["e"] = dict(forward_err=f_err, grad_err=g_err)
    dist.destroy_process_group()
    return stats


def _state_err(got, want):
    """(worst, key): the largest max|a - w| over the leaf's own max|w|
    between the train states `got` (DTensors) and `want`, leaf by leaf,
    and the leaf where it is; a leaf whose max|w| is 0 counts 0 where a
    equals it and inf otherwise."""
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.sharding import api
    worst, where = 0.0, None
    for (key, a), (_, w) in zip(flatten(got), flatten(want)):
        a, w = api.whole(a).float(), w.float()
        diff, scale = float((a - w).abs().max()), float(w.abs().max())
        err = diff / scale if scale else (0.0 if diff == 0 else math.inf)
        if err > worst or where is None:
            worst, where = err, key
    return worst, where


def _mesh_train(dev, smi, mesh):
    """Phase 18 (b): stablelm-1.6b at full width and MESH_TRAIN_LAYERS
    layers, MESH_TRAIN_SHAPE, two steps of `make_train_step(...,
    grad_shardings=)` on a state laid out by `make_state_shardings` and
    batches by `batch_sharding`, against the unsharded step from the same
    state.  After each step the loss and the gradient norm agree within
    MESH_LOSS_TOL, and every leaf of the state - the parameters and both
    Adam moments, which the gradients set (m = 0.1 g after the first
    step, while the first update moves a parameter by lr x 0.005, below
    its bf16 spacing) - within MESH_STATE_TOL of the leaf's own max.  No
    flash launch (autograd takes the chunked route).  Returns (stats,
    the initial state, the sharded state after step 2, the run)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention
    from repro_torch.optim.adamw import AdamW
    from repro_torch.sharding import api, partition
    from repro_torch.train.train_step import init_train_state, \
        make_train_step
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=MESH_TRAIN_LAYERS)
    run = RunConfig(model=cfg, **MESH_TRAIN_SHAPE)
    opt = AdamW(lr=run.learning_rate)
    state, _ = init_train_state(torch.Generator(device=dev).manual_seed(0),
                                cfg, run, opt)
    data = SyntheticLM(cfg, run, seed=0, device=dev)
    walls = {"unsharded": [], "sharded": []}
    after = {"unsharded": [], "sharded": []}

    def run_steps(what, step, st, place_batch):
        for i in range(2):
            batch = place_batch(data.batch(i))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = step(st, batch)
            torch.cuda.synchronize()
            walls[what].append(time.perf_counter() - t0)
            after[what].append((st, float(m["loss"]),
                                float(m["grad_norm"])))
        return st

    run_steps("unsharded", make_train_step(cfg, run, opt), state,
              lambda b: b)
    flash_attention.flash_attention.launches = 0
    with api.policy_scope(partition.make_policy(mesh, cfg, run)):
        placed = partition.distribute(state, partition.make_state_shardings(
            state, mesh, run.fsdp))
        gsh = partition.make_param_shardings(state.params, mesh, run.fsdp)
        bsh = partition.batch_sharding(mesh, cfg, run)
        new = run_steps(
            "sharded", make_train_step(cfg, run, opt, grad_shardings=gsh),
            placed, lambda b: {k: partition.distribute(x, bsh)
                               for k, x in b.items()})
    launches = flash_attention.flash_attention.launches
    print(f"  (b) {cfg.name} at {cfg.n_layers} of 24 layers, "
          f"({run.global_batch}, {run.seq_len}) tokens in microbatches of "
          f"{run.microbatch}, FSDP; flash launches {launches}")
    checks = []
    for i, ((got, loss, gnorm), (want, ref_loss, ref_gnorm)) in enumerate(
            zip(after["sharded"], after["unsharded"])):
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        gnorm_rel = abs(gnorm - ref_gnorm) / abs(ref_gnorm)
        worst, where = _state_err(got, want)
        print(f"    step {i}: loss {loss:.6f} vs unsharded {ref_loss:.6f} "
              f"(relative {loss_rel:.3e}), grad norm {gnorm:.6f} vs "
              f"{ref_gnorm:.6f} (relative {gnorm_rel:.3e}), tolerance "
              f"{MESH_LOSS_TOL:g}; state (parameters, m, v) worst "
              f"{worst:.3e} of the leaf's max|x| at {where} (tolerance "
              f"{MESH_STATE_TOL:g})")
        if not loss_rel <= MESH_LOSS_TOL:
            _fail(f"sharded step {i} loss off by {loss_rel:.3e}")
        if not gnorm_rel <= MESH_LOSS_TOL:
            _fail(f"sharded step {i} gradient norm off by {gnorm_rel:.3e}")
        if not worst <= MESH_STATE_TOL:
            _fail(f"sharded state after step {i} off by {worst:.3e} of "
                  f"the leaf's max at {where}")
        checks.append(dict(loss_rel=loss_rel, grad_norm_rel=gnorm_rel,
                           state_err=worst, state_err_at=where))
    print(f"  step walls (host clock, {smi}): unsharded "
          f"{walls['unsharded'][0]:.3f} / {walls['unsharded'][1]:.3f} s, "
          f"sharded {walls['sharded'][0]:.3f} / {walls['sharded'][1]:.3f} s")
    if launches:
        _fail(f"the sharded training step launched the flash kernel "
              f"{launches} times")
    return (dict(steps=checks, flash_launches=launches, walls_s=walls),
            state, new, run)


# Phase 19's cells (the dry run, `launch/dryrun.py`): production cells on
# a fake 256-rank world (2x16x16: 512), and two traces on a fake one-rank
# mesh of the steps that phases 15 and 12 run on the card.
DRYRUN_CELLS = {
    "stablelm-1.6b train_4k": ("lm", dict(arch="stablelm-1.6b",
                                          shape_key="train_4k")),
    "phase 15's step, one rank": ("lm", dict(
        arch=TRAIN_ARCH, shape_key="train_4k", mesh_shape=(1, 1),
        run=TRAIN_SHAPE)),
    "glm4-9b prefill_32k": ("lm", dict(arch="glm4-9b",
                                       shape_key="prefill_32k")),
    "phase 12's prefill, one rank": ("lm", dict(
        arch="glm4-9b", shape_key="prefill_32k", mesh_shape=(1, 1),
        run=dict(mode="prefill", seq_len=1024, global_batch=4))),
    "mamba2-130m decode_32k": ("lm", dict(arch="mamba2-130m",
                                          shape_key="decode_32k")),
    "mamba2-130m decode_32k, 2x16x16": ("lm", dict(
        arch="mamba2-130m", shape_key="decode_32k", multi_pod=True)),
    "BlockAMC solver n=2048 s=1": ("solver", dict(n=2048, stages=1)),
}
# The train_4k cells on 16x16 that phase 19 holds (stablelm-1.6b's is
# above), longest trace first: the two dense kinds, context parallelism
# (recurrentgemma-2b: 10 heads on a 16-wide axis), the MoE and
# Megatron-SP (`seq_shard`, 10e9 parameters and more).  The tenth,
# llama4-maverick (16 microbatches of 48 layers: a trace of ~7 minutes
# on the card's host), is `tests/test_torch_dryrun.py`'s slow test.
DRYRUN_TRAIN = ("glm4-9b", "command-r-35b", "chatglm3-6b",
                "phi3.5-moe-42b-a6.6b", "pixtral-12b", "recurrentgemma-2b",
                "musicgen-medium", "mamba2-130m")
DRYRUN_CELLS = dict({f"{arch} train_4k": ("lm", dict(
    arch=arch, shape_key="train_4k")) for arch in DRYRUN_TRAIN},
    **DRYRUN_CELLS)
# The reference's train_4k cells on its 16x16 mesh, a chip's (peak bytes
# - XLA's argument + temp -, FLOPs, collective bytes), as
# `python probes/ref_dryrun_train.py` prints them (jax 0.9.0, 256 fake
# host devices; the JAX package runs on a host, never here).
REF_TRAIN_4K = {
    "stablelm-1.6b": (10783436180, 4.8550310313984e13, 9.4009720936e10),
    "glm4-9b": (9239258116, 3.08172493422592e14, 3.73138063496e11),
    "chatglm3-6b": (6415323236, 2.11587268870144e14, 2.62248497288e11),
    "command-r-35b": (15873535828, 1.00261716557824e15, 1.255923732584e12),
    "pixtral-12b": (7022060332, 3.9376260169728e14, 6.0509313444e11),
    "recurrentgemma-2b": (8853535844, 9.216999817216e13, 1.8576888048e11),
    "phi3.5-moe-42b-a6.6b": (9721763036, 2.89412076273664e14,
                             5.50163132524e11),
    "llama4-maverick-400b-a17b": (33982193428, 5.0425063538688e14,
                                  2.977298114844e12),
    "musicgen-medium": (10650702844, 6.4398739636224e13, 1.72252741736e11),
    "mamba2-130m": (2350626212, 3.996735504384e12, 8.5419228732e10),
}
# Phase 19 (d): every serving cell the dry run traces on 16x16 (the
# long_500k cells of full-attention archs are skipped on both sides) and
# the paper's solver at n=2048 (one stage) and n=16384 (two).  The
# reference's, a chip's (peak bytes, FLOPs, collective bytes), keyed
# "arch|shape", as `PYTHONPATH=src python probes/ref_dryrun_serve.py`
# prints them (jax 0.9.0, 256 fake host devices, on a host).
REF_SERVE = {
    "blockamc-solver|n2048_s1": (157378376, 24903680.0, 5587976.0),
    "blockamc-solver|n16384_s2": (844361544, 16099573760.0, 231107592.0),
    "recurrentgemma-2b|prefill_32k":
        (5371148016, 29334790471680.0, 48257264144.0),
    "recurrentgemma-2b|decode_32k": (371513492, 2977955840.0, 51483776.0),
    "recurrentgemma-2b|long_500k": (60312696, 30474240.0, 481884.0),
    "llama4-maverick-400b-a17b|prefill_32k":
        (23198684104, 239144037908480.0, 270685728784.0),
    "llama4-maverick-400b-a17b|decode_32k":
        (26542204924, 74535403520.0, 6378538880.0),
    "phi3.5-moe-42b-a6.6b|prefill_32k":
        (8581007936, 133178378944512.0, 122233536528.0),
    "phi3.5-moe-42b-a6.6b|decode_32k":
        (8990844348, 90596966400.0, 902047872.0),
    "pixtral-12b|prefill_32k": (6520656592, 177296417751040.0, 118344990736.0),
    "pixtral-12b|decode_32k": (10025609132, 22313697280.0, 206602368.0),
    "glm4-9b|prefill_32k": (4690658416, 154790776537088.0, 95828705296.0),
    "glm4-9b|decode_32k": (2788086284, 19516096512.0, 161892480.0),
    "stablelm-1.6b|prefill_32k": (1980244784, 36490093527040.0, 28477161488.0),
    "stablelm-1.6b|decode_32k": (11636419660, 4659871744.0, 27672704.0),
    "command-r-35b|prefill_32k":
        (9861104464, 406819826565120.0, 191415320592.0),
    "command-r-35b|decode_32k": (10905622444, 51757711360.0, 518504576.0),
    "chatglm3-6b|prefill_32k": (4538762224, 108353501528064.0, 65649311760.0),
    "chatglm3-6b|decode_32k": (1931547148, 13493075968.0, 110775424.0),
    "musicgen-medium|prefill_32k":
        (1767840792, 54425826361344.0, 70747594768.0),
    "musicgen-medium|decode_32k": (17164403860, 6646923264.0, 37232768.0),
    "mamba2-130m|prefill_32k": (1433217904, 926112006144.0, 38855439376.0),
    "mamba2-130m|decode_32k": (327004704, 133693440.0, 16219520.0),
    "mamba2-130m|long_500k": (47648580, 1056768.0, 1622924.0),
}
# The targets: the cells repaired for the production mesh (FLOPs a chip
# at most this many times the reference's); every other cell counts the
# reference's to SERVE_EQUAL_TOL, except a dense prefill on the card's
# route, whose flash op counts the causal pairs alone (S (S + 1) / 2 a
# head, `kernels/ops.flash_flops`) where the reference's chunked
# attention counts the masked S^2: at most the reference's.
SERVE_TARGETS = {
    "blockamc-solver|n2048_s1": 2.0, "blockamc-solver|n16384_s2": 2.0,
    "musicgen-medium|prefill_32k": 1.05,
    "llama4-maverick-400b-a17b|prefill_32k": 1.05,
    "phi3.5-moe-42b-a6.6b|decode_32k": 1.05,
    "llama4-maverick-400b-a17b|decode_32k": 1.05,
    "recurrentgemma-2b|prefill_32k": 1.05,
    # the SSD's channels shared evenly over "model" and its C B^T a share
    # of the chunks a rank (the reference's split); was 1.15 for the
    # uneven head split and the repeated C B^T
    "mamba2-130m|decode_32k": 1.02, "mamba2-130m|long_500k": 1.02,
    "mamba2-130m|prefill_32k": 1.02,
    # p . v's heads shared over the ranks holding the same cache slots
    # (the reference halves them, f32[256,5]); was 1.10
    "recurrentgemma-2b|long_500k": 1.02,
}
SERVE_EQUAL_TOL = 1e-3
# Collective bytes a chip at most this many times the reference's, where
# a repair moved them (the gates' weights were gathered for a decode
# token, 5.5x; the port's other cells sit at 0.09-1.10x)
SERVE_COLL_TARGETS = {"recurrentgemma-2b|long_500k": 2.0}
# Every prefill cell's peak a chip at most this many times the
# reference's: the dense ones on the flash op (the KV cache built on each
# rank's own block, never gathered whole), the chunked route's (one
# float32 copy of a query chunk's scores, the projections never whole)
# and the SSD's (its in-projection and gated norm on each rank's share)
SERVE_PEAK_REF = 1.3


def _serve_label(key):
    arch, shape = key.split("|")
    if arch == "blockamc-solver":
        n, stages = (int(x[1:]) for x in shape.split("_"))
        return f"BlockAMC solver n={n} s={stages}"
    return f"{arch} {shape}"


def _serve_spec(key):
    arch, shape = key.split("|")
    if arch == "blockamc-solver":
        n, stages = (int(x[1:]) for x in shape.split("_"))
        return ("solver", dict(n=n, stages=stages))
    return ("lm", dict(arch=arch, shape_key=shape))


DRYRUN_CELLS = dict(DRYRUN_CELLS, **{
    _serve_label(key): _serve_spec(key) for key in REF_SERVE
    if _serve_label(key) not in DRYRUN_CELLS})
DRYRUN_FLOP_TOL = 1e-6   # a trace's FLOPs vs FlopCounterMode's on the card:
#                          the same ops counted by the same formulas
DRYRUN_PEAK_TOL = 0.15   # a trace's peak vs the card's: the allocator's
#                          rounding and workspaces, DTensor's one-rank copies
CHIP_BYTES = 80e9        # an H100's memory: every train cell must fit
TRAIN_SCALED_TOL = 1e-3  # stablelm train_4k's FLOPs a chip vs phase 15's
#                          count x 32 / 256: the same ops, each chip an even
#                          share (the share's rounding of odd counts)
TRAIN_REF_TOL = 0.05     # glm4-9b's and chatglm3-6b's FLOPs a chip vs the
#                          reference's: the same products, counted per op
TRAIN_PEAK_REF = 2.0     # stablelm's peak vs the reference's: live tensors
#                          op by op here, XLA's buffers after fusion there
TRAIN_TARGETS = {        # FLOPs a chip at most this many times the
    "mamba2-130m": 1.02,   # reference's: the SSD's channels and C B^T
    #                        shared evenly over "model" (was 1.1017x)
    "phi3.5-moe-42b-a6.6b": 1.0002,  # the router's weight gradient a
    #                        slice a rank of "model" (was 1.0009x)
}


def _dryrun_cell(spec):
    """One dry-run cell, run in a process of its own (phase 19: a fake
    world is one a process).  Returns the cell's report with the
    process's seconds, or the traceback under "error"."""
    kind, kw = spec
    t0 = time.perf_counter()
    try:
        from repro_torch.launch import dryrun
        if kind == "solver":
            report = dryrun.lower_solver_cell(**kw)
        else:
            kw = dict(kw)
            run = kw.pop("run", None)
            if run is not None:
                from repro_torch.configs import get_config
                from repro_torch.configs.base import RunConfig
                kw["run_override"] = RunConfig(model=get_config(kw["arch"]),
                                               **run)
            report = dryrun.lower_cell(**kw)
    except Exception:
        import traceback
        report = {"error": traceback.format_exc()}
    report["process_s"] = time.perf_counter() - t0
    return report


def _dryrun_phase(smi, lm_stats, train):
    """Phase 19: the dry run (`launch/dryrun.py`) on the card's host, each
    cell traced as rank 0 of a fake world on fake "cuda" tensors (no
    allocation, no launch), the cells in parallel processes.  (a) The
    production cells `DRYRUN_CELLS` names: each prints its dominant
    roofline term, the three terms, FLOPs, bytes and collective bytes a
    chip, its peak and its seconds; glm4-9b's prefill_32k reaches the
    attention op's fake implementation once a layer.  (b) The card
    against the analysis: the one-rank traces of phase 15's training step
    and phase 12's prefill count the FLOPs `FlopCounterMode` counted on
    the card to DRYRUN_FLOP_TOL, their peak is within DRYRUN_PEAK_TOL of
    the card's, and each measured wall is at least its compute term.
    (c) The train_4k cells (`_train_cells`).  (d) The serving and solver
    cells (`_serve_cells`).  Returns the reports."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import os
    print(f"phase 19: the dry run on fake worlds, {len(DRYRUN_CELLS)} "
          f"cells in parallel processes (fake tensors: no card) ({smi})")
    workers = max(1, min(len(DRYRUN_CELLS), (os.cpu_count() or 2) - 1))
    t0 = time.perf_counter()
    with cf.ProcessPoolExecutor(max_workers=workers,
                                mp_context=mp.get_context("spawn")) as pool:
        futures = {label: pool.submit(_dryrun_cell, spec)
                   for label, spec in DRYRUN_CELLS.items()}
        reports = {label: f.result() for label, f in futures.items()}
    print(f"  {workers} processes, {time.perf_counter() - t0:.1f} s")
    for label, r in reports.items():
        if "error" in r:
            _fail(f"dry run {label}: {r['error']}")
        terms = r["roofline"]
        print(f"  {label} on {r['mesh']} ({r['n_chips']} chips, "
              f"{r['device']}): dominant {r['dominant']}; compute "
              f"{terms['compute_s']:.4e} s, memory {terms['memory_s']:.4e} "
              f"s, collective {terms['collective_s']:.4e} s; a chip "
              f"{r['flops_per_chip']:.6e} FLOPs, {r['bytes_per_chip']:.4e} "
              f"bytes, {r['collective_bytes_per_chip']:.4e} collective "
              f"bytes; peak {r['memory']['peak_bytes'] / 1e9:.3f} GB; "
              f"trace {r['compile_s']} s, {r['process_s']:.1f} s in its "
              f"process")
        if not (r["flops_per_chip"] > 0 and r["dominant"]):
            _fail(f"dry run {label}: no FLOPs or no dominant term")
    calls = reports["glm4-9b prefill_32k"]["flash_calls"]
    print(f"  glm4-9b prefill_32k: {calls} calls of the attention op's fake "
          f"implementation")
    if calls != 40:
        _fail(f"glm4-9b prefill_32k reached the attention op {calls} "
              f"times, expected 40 (one a layer)")
    checks = (("phase 15's step, one rank", "training step",
               train["counted_flops"], train["peak_gb"] * 1e9,
               train["step_s"]),
              ("phase 12's prefill, one rank", "prefill",
               lm_stats["prefill_flops"], lm_stats["prefill_peak_bytes"],
               lm_stats["prefill_ms"] / 1e3))
    for label, what, flops, peak, wall in checks:
        r = reports[label]
        rel = abs(r["flops_per_chip"] - flops) / flops
        traced = r["memory"]["peak_bytes"]
        off = traced / peak - 1
        compute_s = r["roofline"]["compute_s"]
        print(f"  (b) the {what}: trace {r['flops_per_chip']:.6e} FLOPs vs "
              f"the card's FlopCounterMode {flops:.6e} ({rel:.2e} "
              f"relative, tolerance {DRYRUN_FLOP_TOL:g}); peak "
              f"{traced / 1e9:.3f} GB vs {peak / 1e9:.3f} GB ({off:+.1%}, "
              f"tolerance {DRYRUN_PEAK_TOL:.0%}); measured {wall:.4f} s vs "
              f"compute term {compute_s:.4f} s ({compute_s / wall:.1%})")
        if not rel <= DRYRUN_FLOP_TOL:
            _fail(f"the {what}'s trace counts {rel:.2e} off the card's")
        if not abs(off) <= DRYRUN_PEAK_TOL:
            _fail(f"the {what}'s traced peak is {off:+.1%} off the card's")
        if not wall >= compute_s:
            _fail(f"the {what} ran faster than its compute term")
    _train_cells(reports, train)
    _serve_cells(reports)
    return reports


def _serve_cells(reports):
    """Phase 19 (d): each serving cell on 16x16 and both solver cells,
    traced on fake "cuda" tensors (a dense prefill reaches the flash op),
    beside the reference's (`REF_SERVE`): the repaired cells within
    SERVE_TARGETS, the others equal to SERVE_EQUAL_TOL (a flash-route
    prefill at most the reference's), every peak under a chip's
    memory, each prefill's within SERVE_PEAK_REF of the reference's
    with the largest storages live at its peak printed
    (`peak_live`), the collective bytes within SERVE_COLL_TARGETS."""
    print("  (d) the serving and solver cells on 16x16, a chip, beside the "
          "reference's (probes/ref_dryrun_serve.py):")
    for key, (ref_peak, ref_flops, ref_coll) in REF_SERVE.items():
        label = _serve_label(key)
        r = reports[label]
        peak, flops = r["memory"]["peak_bytes"], r["flops_per_chip"]
        ratio = flops / ref_flops
        flash = r.get("flash_calls", 0)
        target = SERVE_TARGETS.get(key)
        bound = "" if target is None else f", target <= {target:g}x"
        print(f"    {label}: FLOPs {flops:.6e} ({ref_flops:.4e}, "
              f"{ratio:.4f}x{bound}); peak {peak / 1e9:.3f} GB (reference "
              f"{ref_peak / 1e9:.3f}); collective bytes "
              f"{r['collective_bytes_per_chip']:.4e} ({ref_coll:.4e}); "
              f"flash op {flash}; trace {r['compile_s']} s")
        if not peak < CHIP_BYTES:
            _fail(f"{label} peaks at {peak / 1e9:.3f} GB a chip, over "
                  f"{CHIP_BYTES / 1e9:.0f} GB")
        if key.endswith("|prefill_32k"):
            limit = SERVE_PEAK_REF * ref_peak
            print(f"      peak bound {limit / 1e9:.3f} GB "
                  f"({peak / ref_peak:.3f}x the reference's); live at "
                  f"the peak:")
            for e in r["peak_live"]:
                print(f"        {e['bytes'] / 1e9:.3f} GB {e['dtype']}"
                      f"{e['shape']} from {e['op']}")
            if not peak <= limit:
                _fail(f"{label} peaks at {peak / 1e9:.3f} GB a chip, over "
                      f"its bound {limit / 1e9:.3f} GB")
        coll = r["collective_bytes_per_chip"]
        if key in SERVE_COLL_TARGETS and \
                not coll <= SERVE_COLL_TARGETS[key] * ref_coll:
            _fail(f"{label} moves {coll / ref_coll:.2f}x the reference's "
                  f"collective bytes a chip")
        if target is not None:
            ok = ratio <= target
        elif flash:
            ok = ratio <= 1 + SERVE_EQUAL_TOL
        else:
            ok = abs(ratio - 1) <= SERVE_EQUAL_TOL
        if not ok:
            _fail(f"{label} counts {ratio:.4f}x the reference's FLOPs a "
                  f"chip")
    r = reports["BlockAMC solver n=2048 s=1"]
    want = (2048 // 16) ** 2 * 4 + 2048 * 4
    print(f"    the solver's arguments a chip: "
          f"{r['memory']['argument_bytes']} B (A's 128 x 128 block and b: "
          f"{want} B)")
    if r["memory"]["argument_bytes"] != want:
        _fail("the solver cell's arguments are not A's 1/256 block and b")


def _train_cells(reports, train):
    """Phase 19 (c): every train_4k cell fits a chip, each printed beside
    the reference's (`REF_TRAIN_4K`); stablelm-1.6b's FLOPs a chip equal
    phase 15's count on the card scaled from (8, 4096) tokens on one chip
    to (256, 4096) on 256, and its peak stays within TRAIN_PEAK_REF of the
    reference's; glm4-9b's and chatglm3-6b's FLOPs within TRAIN_REF_TOL of
    the reference's, and the repaired cells' within TRAIN_TARGETS."""
    print("  (c) train_4k on 16x16, a chip, beside the reference's "
          "(probes/ref_dryrun_train.py):")
    for arch in ("stablelm-1.6b",) + DRYRUN_TRAIN:
        r = reports[f"{arch} train_4k"]
        peak, flops = r["memory"]["peak_bytes"], r["flops_per_chip"]
        coll = r["collective_bytes_per_chip"]
        ref_peak, ref_flops, ref_coll = REF_TRAIN_4K[arch]
        print(f"    {arch}: peak {peak / 1e9:.3f} GB (reference "
              f"{ref_peak / 1e9:.3f}, {peak / ref_peak:.3f}x); FLOPs "
              f"{flops:.6e} ({ref_flops:.4e}, {flops / ref_flops:.4f}x); "
              f"collective bytes {coll:.4e} ({ref_coll:.4e}, "
              f"{coll / ref_coll:.3f}x); trace {r['compile_s']} s")
        if not peak < CHIP_BYTES:
            _fail(f"{arch} train_4k peaks at {peak / 1e9:.3f} GB a chip, "
                  f"over {CHIP_BYTES / 1e9:.0f} GB")
        if arch in ("glm4-9b", "chatglm3-6b") and not \
                abs(flops / ref_flops - 1) <= TRAIN_REF_TOL:
            _fail(f"{arch} train_4k counts {flops / ref_flops:.4f}x the "
                  f"reference's FLOPs a chip")
        if arch in TRAIN_TARGETS and not \
                flops / ref_flops <= TRAIN_TARGETS[arch]:
            _fail(f"{arch} train_4k counts {flops / ref_flops:.4f}x the "
                  f"reference's FLOPs a chip, over "
                  f"{TRAIN_TARGETS[arch]:g}x")
    r = reports["stablelm-1.6b train_4k"]
    want = train["counted_flops"] * 32 / 256
    rel = abs(r["flops_per_chip"] - want) / want
    ratio = r["memory"]["peak_bytes"] / REF_TRAIN_4K["stablelm-1.6b"][0]
    print(f"    stablelm-1.6b: {r['flops_per_chip']:.6e} FLOPs a chip vs "
          f"phase 15's {train['counted_flops']:.6e} x 32 / 256 = "
          f"{want:.6e} ({rel:.2e} relative, tolerance "
          f"{TRAIN_SCALED_TOL:g}); peak {ratio:.3f}x the reference's "
          f"(at most {TRAIN_PEAK_REF:g}x)")
    if not rel <= TRAIN_SCALED_TOL:
        _fail(f"stablelm-1.6b train_4k counts {rel:.2e} off phase 15's "
              f"count scaled")
    if not ratio <= TRAIN_PEAK_REF:
        _fail(f"stablelm-1.6b train_4k peaks at {ratio:.3f}x the "
              f"reference's")


def _print_ptxas(log):
    """Each kernel instance's registers, static shared memory and spills,
    from the compiler's `-Xptxas -v` report, under its name."""
    import re
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = re.search(r"\d([a-z]+(?:_[a-z0-9]+)*_kernel)(I\w*?EE)?",
                             entry[1])       # after its length prefix
            print(f"    {name[1] + (name[2] or '') if name else entry[1]}:")
        elif "registers" in line or "spill" in line or "smem" in line:
            print(f"      {line.strip()}")


def _print_smem(build):
    """The dynamic shared memory a block of the tensor-core kernels takes
    (ptxas reports static shared memory only)."""
    import ctypes
    flash, schur = build.load("flash_attention"), build.load("schur_gemm")
    banded = build.load("banded_solve")
    xbar, arena = build.load("crossbar_mvm"), build.load("arena_mvm")
    for fn in (flash.flash_smem_bytes, schur.schur_smem_bytes):
        fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    tridiag = banded.block_tridiag_smem_bytes
    tridiag.argtypes, tridiag.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    print("  dynamic shared memory a block: flash bf16 D=128 "
          f"{flash.flash_smem_bytes(1, 128)} B, D=64 "
          f"{flash.flash_smem_bytes(1, 64)} B; flash f32 (3xTF32) D=128 "
          f"{flash.flash_smem_bytes(0, 128)} B, D=64 "
          f"{flash.flash_smem_bytes(0, 64)} B; Schur 3xTF32 64-row tiles "
          f"{schur.schur_smem_bytes(0, 1)} B, 32-row "
          f"{schur.schur_smem_bytes(0, 0)} B; Schur bf16 "
          f"{schur.schur_smem_bytes(1, 1)} B; block-Thomas f32 s=64 8 "
          f"columns {tridiag(0, 64, 8)} B, s=256 16 columns "
          f"{tridiag(0, 256, 16)} B, f64 s=64 8 columns "
          f"{tridiag(1, 64, 8)} B")
    fn = xbar.crossbar_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    area = arena.arena_smem_bytes
    area.argtypes, area.restype = [ctypes.c_int] * 6, ctypes.c_longlong
    print(f"  crossbar tf32 {fn(0)} B (bf16 conductances {fn(1)} B); "
          f"arena smem instance at the main path (S=704, T=23, J=3, "
          f"C=64, 1 column, 3 slots) {area(704, 23, 3, 64, 1, 3)} B, "
          f"16 columns {area(704, 23, 3, 64, 16, 3)} B")


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
        _print_ptxas(info["log"])
    _print_smem(_build)

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
        # (instance, column slice, ring slots)
        instance = arena_mvm.device_plan(dev, m, s, k, n_tiles, rc, n_terms)
        arena0 = torch.rand((m, s, k), generator=gen, device=dev) * 2 - 1
        ops = torch.randn((m, n_tiles, rc, rc), generator=gen, device=dev) \
            * (0.5 / rc ** 0.5)
        kw = dict(dac_bits=bits, adc_bits=bits)
        plain = ref.arena_packed_ref(arena0, ops, *meta, **kw)
        out = arena_mvm.arena_packed_apply(arena0.clone(), ops, *meta, **kw)
        torch.cuda.synchronize()
        what = (f"{label}: M={m} T={n_tiles} R=C={rc} J={n_terms} S={s} "
                f"K={k}, instance {instance}")
        if bits is None:
            err = _check_close(what, out, plain, KERNEL_REL_TOL)
        else:
            err = _check_quantized(what, out, plain, 2.0 / (2 ** bits - 1))
        scratch = arena0.clone()

        def kernel():
            arena_mvm.arena_packed_apply(scratch, ops, *meta, **kw)
        ms = _time_ms(kernel, reps=7, per_batch=20)
        graph_ms = _graph_ms(kernel)
        plain_ms = _time_ms(lambda: ref.arena_packed_ref(
            arena0, ops, *meta, **kw), reps=3, per_batch=2)
        bound_ms, bound_by = _bound(m, s, k, n_tiles, rc, rc, n_terms,
                                    bits)
        print(f"  kernel {ms:.4f} ms (graph {graph_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.2%} of the bound")
        stats[label] = dict(err=err, ms=ms, graph_ms=graph_ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, instance=instance)
        if label == "main path":    # the chain of dependent tiles
            ops1 = ops[:, :1].contiguous()
            meta1 = tuple(x[:1].contiguous() for x in meta)
            first_ms = _graph_ms(lambda: arena_mvm.arena_packed_apply(
                scratch, ops1, *meta1, **kw))
            tile_ms = (graph_ms - first_ms) / (n_tiles - 1)
            print(f"  the first tile alone {first_ms:.4f} ms (graph: "
                  f"launch, prologue, epilogue); each further tile "
                  f"{tile_ms:.5f} ms")
            stats[label].update(first_tile_graph_ms=first_ms,
                                tile_graph_ms=tile_ms)

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
    level_ms = []
    for _ in range(5):                   # steady: host clock, synchronised
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        big.solve_many(b_big)
        torch.cuda.synchronize()
        level_ms.append((time.perf_counter() - t0) * 1e3)
    level_steady_ms = statistics.median(level_ms)
    print(f"  steady solve_many ({groups} launches, host clock, median of "
          f"5): {level_steady_ms:.3f} ms")

    # -- 6-8. the nodal wire model ----------------------------------------
    banded_stats = _banded_phase(dev)
    t0 = time.perf_counter()
    fig9_launches = _fig9_phase(dev)
    print(f"  phase 7 took {time.perf_counter() - t0:.1f} s")
    serve_banded, serve_arena, _ = _nodal_serving_phase(dev)

    # -- 9-10. slice 3: the kernel bench's rows, the example's path ----------
    t0 = time.perf_counter()
    bench_stats, bench_launches = _bench_phase(dev)
    print(f"  phase 9 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    example_launches = _example_phase(dev, svc, ids[0], mats[0])
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s")

    # -- 11-12. slice 4: the attention kernel, the LM serving path ---------
    t0 = time.perf_counter()
    flash_stats = _flash_phase(dev)
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_launches, lm_stats = _lm_phase(dev)
    print(f"  phase 12 took {time.perf_counter() - t0:.1f} s")

    # -- 13. the maintained serving path -------------------------------------
    t0 = time.perf_counter()
    maint = _maintenance_phase(dev, smi)
    print(f"  phase 13 took {time.perf_counter() - t0:.1f} s")

    # -- 14. the async engine and the replicated fleet ----------------------
    t0 = time.perf_counter()
    fleet_launches, fleet = _fleet_phase(dev, smi, root)
    print(f"  phase 14 took {time.perf_counter() - t0:.1f} s")

    # -- 15. the training path and the BlockAMC preconditioner -------------
    t0 = time.perf_counter()
    train = _train_phase(dev, root)
    print(f"  phase 15 took {time.perf_counter() - t0:.1f} s")

    # -- 16. the Monte-Carlo mesh --------------------------------------------
    t0 = time.perf_counter()
    mc_launches, mc = _mc_mesh_phase(dev)
    print(f"  phase 16 took {time.perf_counter() - t0:.1f} s")

    # -- 17. the MoE, RG-LRU and SSD families -------------------------------
    t0 = time.perf_counter()
    families = _lm_families_phase(dev, smi)
    print(f"  phase 17 took {time.perf_counter() - t0:.1f} s")

    # -- 18. the language model's mesh -------------------------------------
    t0 = time.perf_counter()
    lm_mesh = _lm_mesh_phase(dev, smi, lm_stats)
    print(f"  phase 18 took {time.perf_counter() - t0:.1f} s")

    # -- 19. the dry run ------------------------------------------------------
    t0 = time.perf_counter()
    dryrun = _dryrun_phase(smi, lm_stats, train)
    print(f"  phase 19 took {time.perf_counter() - t0:.1f} s")

    # -- 20. the nodal kernel against the dense MNA oracle ------------------
    t0 = time.perf_counter()
    mna_launches, mna = _mna_phase(dev, smi)
    print(f"  phase 20 took {time.perf_counter() - t0:.1f} s")

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
        "graph_ms": main["graph_ms"],
        "instance": main["instance"],
        "shapes": stats,
        "steady_flush_all_ms": steady_ms,
        "steady_per_level_ms": level_steady_ms,
        "launches_by_path": {"main path (flush_all + flush)": main_launches,
                             "per-level (n=1024)": level_launches,
                             "nodal serving (flush_all)": serve_arena,
                             "example path (phase 10)":
                                 example_launches["arena_packed_apply"],
                             **{path: maint[path] for path in (
                                 "maintained flush_all (phase 13)",
                                 "kernel-path gradients (phase 13)",
                                 "calibrate_wire forwards (phase 13)")},
                             "replicated fleet (phase 14)": sum(
                                 count for label, count
                                 in fleet_launches.items()
                                 if label != "faulted_engine"),
                             "async engine, faulted (phase 14)":
                                 fleet_launches["faulted_engine"],
                             "stablelm-1.6b training (phase 15)":
                                 train["arena_launches"],
                             "BlockAMCPrecond analog refresh (phase 15)":
                                 train["precond"]["analog_launches"],
                             **{f"{what}, sharded (phase 16)": count
                                for what, count in mc_launches.items()}},
        "maintenance": {key: maint[key] for key in (
            "repair_ms", "program_ms", "calibration_s", "r_hat")},
        "fleet": fleet,
        "mc_mesh": mc,
    }]
    solver = banded_stats["solver path"]
    kernels.append({
        "name": "block_tridiag_solve",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/banded_solve.cu",
        "replaces": "src/repro/kernels/banded_solve.py:82",
        "launches": fig9_launches + serve_banded
        + maint["calibrate_wire nodal oracle (phase 13)"] + mna_launches,
        "max_abs_err": solver["err"],
        "ms": solver["ms"],
        "plain_ms": solver["plain_ms"],
        "bound_ms": solver["bound_ms"],
        "bound_by": solver["bound_by"],
        "library_ms": None,
        "launches_by_path": {"Fig. 9 Monte-Carlo (phase 7)": fig9_launches,
                             "nodal serving (phase 8)": serve_banded,
                             "calibrate_wire nodal oracle (phase 13)":
                                 maint["calibrate_wire nodal oracle "
                                       "(phase 13)"],
                             "nodal route vs the MNA oracle (phase 20)":
                                 mna_launches},
        "mna_oracle": mna,
        "shapes": {label: {key: st[key] for key in
                           ("err", "ms", "plain_ms", "bound_ms", "bound_by")}
                   for label, st in banded_stats.items()
                   if isinstance(st, dict)},
    })
    rows = {"crossbar_mvm": ("crossbar (512,1024,1024) 8-bit",
                             "src/repro/kernels/crossbar_mvm.py:82"),
            "crossbar_mvm_batched": ("batched (16,128,128,128) 8-bit",
                                     "src/repro/kernels/crossbar_mvm.py:150"),
            "schur_update": ("Schur n=1024 float32",
                             "src/repro/kernels/schur_gemm.py:46")}
    for name, (headline_row, replaces) in rows.items():
        st = bench_stats[name][headline_row]
        by_path = {"kernel bench rows (phase 9)": bench_launches[name]}
        if name == "crossbar_mvm":
            by_path["example crossbar check (phase 10)"] = \
                example_launches["crossbar_mvm"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": ("src/repro_torch/kernels/csrc/schur_gemm.cu"
                       if name == "schur_update" else
                       "src/repro_torch/kernels/csrc/crossbar_mvm.cu"),
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "max_abs_err": st["err"],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"],
            "library_ms": st["library_ms"],
            "library_ratio": st["library_ratio"],
            "graph_ms": st["graph_ms"],
            "launches_by_path": by_path,
            "shapes": bench_stats[name],
        })
    st = flash_stats["serving prefill"]
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:85",
        "launches": lm_launches,
        "max_abs_err": st["err"],
        "ms": st["ms"],
        "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"],
        "bound_by": st["bound_by"],
        "library_ms": st["library_ms"],
        "library_ratio": st["library_ratio"],
        "launches_by_path": {"glm4-9b Engine.generate (phase 12)":
                                 lm_launches,
                             "stablelm-1.6b training (phase 15)":
                                 train["flash_launches"],
                             **{f"{arch} generate (phase 17)":
                                st["flash_launches"]
                                for arch, st in families.items()},
                             "glm4-9b sharded prefill (phase 18)":
                                 lm_mesh["a"]["flash_launches"],
                             "stablelm-1.6b sharded training (phase 18)":
                                 lm_mesh["b"]["flash_launches"]},
        "shapes": flash_stats,
        "families": families,
        "lm": lm_stats,
        "train": train,
        "lm_mesh": lm_mesh,
        "dryrun": {label: {key: r[key] for key in (
            "mesh", "n_chips", "flops_per_chip", "bytes_per_chip",
            "collective_bytes_per_chip", "roofline", "dominant", "memory",
            "compile_s", "process_s")} for label, r in dryrun.items()},
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
