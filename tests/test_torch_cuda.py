"""The hand-written CUDA kernels on the card, against their plain PyTorch
versions.  Every test here carries the `cuda` marker and skips on a host
without a card; the module imports no JAX, so it runs on a card machine
without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 1e-5 of max|out| with ideal converters (the kernel and the
plain version reassociate f32 sums); with converters on, one-step ADC
flips are allowed (`quantized_close`); whole solves through the kernel
against the plain path at 1e-4 of max|x| (the same sums, cascaded).  The
block-Thomas kernel against its plain version: 1e-5 of max|out| in
float32 and 1e-12 in float64 on well-conditioned random factor stacks
(real nodal factor stacks amplify rounding; chip_smoke.py holds the
kernel to a float64 evaluation there).  The crossbar kernel: 1e-5 of
max|out| ideal, at most one ADC step on at most 2% of outputs with
converters (`one_step_close`); the Schur kernel: 1e-5 of max|out|.  The
attention kernel: 1e-5 of max|out| in float32 (the same online softmax,
sums reassociated); in bfloat16 against the plain version evaluated in
float32 on the same bf16 inputs, element by element within 2^-8 of the
element plus 1e-5 of max|out| (the kernel's one round-to-nearest of its
float32 result to bf16, `bf16_rounding_close`); the model's
two attention routes at 2e-4 of max|logit| in float32, the reference's
in-model tolerance.  Gradients through the kernel path against the plain
path's: 1e-4 of max|g| (the forward's sums reassociated, as whole
solves); a repaired plan's spliced operators against a fresh compile:
1e-5 of max|op| (batched LU on the card may differ in the last bits
between a subset and the whole stack).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import blockamc
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.nonideal import NonidealConfig
from repro_torch.kernels import arena_mvm
from repro_torch.kernels import banded_solve
from repro_torch.kernels import crossbar_mvm
from repro_torch.kernels import flash_attention
from repro_torch.kernels import schur_gemm
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.serve import SolverService
from repro_torch.hybrid import (AnalogPreconditioner, pcg_fixed,
                                solve_refined)
from _torch_parity import (bf16_rounding_close, one_step_close,
                           quantized_close, scaled_close, tile_program)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no "
                    "host mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,bits", [(2, 3, None), (16, 8, None),
                                      (3, 37, None), (3, 37, 8)])
def test_arena_kernel_matches_plain_version(cuda, m, k, bits):
    args = tile_program(m=m, n_tiles=23, rows=64, cols=64, k=k, s=704)
    dev = [torch.from_numpy(x).to(cuda) for x in args]
    kw = dict(dac_bits=bits, adc_bits=bits)
    plain = ref.arena_packed_ref(*dev, **kw)
    before = arena_mvm.arena_packed_apply.launches
    out = ops.arena_packed_apply(dev[0].clone(), *dev[1:], **kw)
    torch.cuda.synchronize()
    assert arena_mvm.arena_packed_apply.launches == before + 1
    if bits is None:
        scaled_close(out.cpu(), plain.cpu(), 1e-5)
    else:
        quantized_close(out.cpu(), plain.cpu(), 2.0 / (2 ** bits - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_tiles,rows,cols,k,s,bits,instance", [
    (1, 5, 8, 8, 2, 60000, None, "global"),    # slice over shared memory
    (1, 5, 8, 8, 2, 60000, 8, "global"),
    (2, 40, 128, 128, 3, 600, None, "smem"),   # 80 panels through 3 slots
    (2, 5, 256, 256, 4, 1024, None, "smem"),   # 256x256 tiles, 3 slots
    (3, 23, 37, 33, 5, 300, None, "smem"),     # odd C: ragged copies
    (3, 23, 37, 33, 5, 300, 8, "smem"),
    (16, 23, 64, 64, 5, 704, 8, "smem"),       # ragged K, 8-bit
    (128, 23, 64, 64, 128, 704, None, "smem")])   # wide: 16 columns a block
def test_arena_kernel_instances_match_plain_version(cuda, m, n_tiles, rows,
                                                    cols, k, s, bits,
                                                    instance):
    _check_arena_case(cuda, m, n_tiles, rows, cols, k, s, bits, instance)


@pytest.mark.cuda
@pytest.mark.parametrize("m,rows,cols,k,s,bits,skip,instance", [
    (16, 64, 64, 8, 704, None, False, "smem"),
    (16, 64, 64, 8, 704, 8, True, "smem"),
    (3, 37, 33, 5, 300, None, True, "smem"),            # odd C
    (128, 64, 64, 128, 704, None, True, "smem")])       # 16 columns
def test_arena_kernel_takes_many_window_terms_and_skips_bad_windows(
        cuda, m, rows, cols, k, s, bits, skip, instance):
    """Six window terms a tile: the first four are read ahead into
    registers, the rest from shared memory on the chain.  A window past
    the arena (offset < 0 or > S - C), in either group, is skipped: the
    plain version gets that term as a zero-sign pad."""
    _check_arena_case(cuda, m, 23, rows, cols, k, s, bits, instance,
                      n_terms=6, skip=skip)


def _check_arena_case(cuda, m, n_tiles, rows, cols, k, s, bits, instance,
                      n_terms=3, skip=False):
    """One launch on the instance `plan` picks (asserted to be
    `instance`) against the plain version."""
    args = tile_program(m=m, n_tiles=n_tiles, rows=rows, cols=cols, k=k,
                        s=s, n_terms=n_terms, seed=rows + cols)
    plain_args = [x.copy() for x in args]
    if skip:
        in_offs, in_signs = args[2], args[3]
        for t, j, off in [(3, 1, s - cols + 1), (5, 5, -7), (6, 4, s)]:
            in_offs[t, j] = off
            in_signs[t, j] = 1.0
            plain_args[2][t, j], plain_args[3][t, j] = 0, 0.0
    dev = [torch.from_numpy(x).to(cuda) for x in args]
    assert arena_mvm.device_plan(cuda, m, s, k, n_tiles, cols,
                                 n_terms)[0] == instance
    kw = dict(dac_bits=bits, adc_bits=bits)
    plain = ref.arena_packed_ref(
        *[torch.from_numpy(x).to(cuda) for x in plain_args], **kw)
    before = arena_mvm.arena_packed_apply.launches
    out = ops.arena_packed_apply(dev[0].clone(), *dev[1:], **kw)
    torch.cuda.synchronize()
    assert arena_mvm.arena_packed_apply.launches == before + 1
    if bits is None:
        scaled_close(out.cpu(), plain.cpu(), 1e-5)
    else:
        quantized_close(out.cpu(), plain.cpu(), 2.0 / (2 ** bits - 1))


@pytest.mark.cuda
def test_cuda_wrapper_keeps_dtype_and_refuses_bad_input(cuda):
    args = [torch.from_numpy(x).to(cuda) for x in tile_program()]
    wide = ops.arena_packed_apply(args[0].double(), *args[1:])
    assert wide.dtype == torch.float64
    scaled_close(wide.float().cpu(), ref.arena_packed_ref(*args).cpu(),
                 1e-5)
    with pytest.raises(ValueError):
        arena_mvm.arena_packed_apply(args[0], args[1][:, :, :, :4],
                                     *args[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("n,asz,stages,uniform", [(64, 16, 2, True),
                                                  (17, 8, 1, False)])
def test_solver_kernel_paths_match_plain_path(cuda, n, asz, stages,
                                              uniform):
    cfg = AnalogConfig(array_size=asz, nonideal=NonidealConfig(sigma=0.05),
                       opa_gain=1e4)
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(4 * n, n, generator=gen)
    solver = blockamc.ProgrammedSolver.program(x.T @ x / (4 * n), gen, cfg,
                                               stages, device=cuda)
    ap = solver.arena
    assert (ap.program is not None) == uniform
    bs = torch.rand(n, 5, generator=gen).to(cuda) * 2 - 1
    before = arena_mvm.arena_packed_apply.launches
    xs = solver.solve_many(bs)
    groups = 1 if uniform else sum(len({t[0] for t in lvl})
                                   for lvl in ap.levels)
    assert arena_mvm.arena_packed_apply.launches == before + groups
    scaled_close(xs.cpu(), blockamc.execute_arena(
        ap, bs, use_kernel=False).cpu(), 1e-4)


@pytest.mark.cuda
def test_service_flush_all_is_one_launch(cuda):
    cfg = AnalogConfig(array_size=4, nonideal=NonidealConfig(sigma=0.05))
    svc = SolverService(cfg, stages=2, device=cuda)
    gen = torch.Generator().manual_seed(0)
    rhs = {}
    for i, k in enumerate([3, 1, 5]):
        x = torch.randn(64, 16, generator=gen)
        svc.program(f"t{i}", x.T @ x / 64, torch.Generator().manual_seed(i))
        rhs[f"t{i}"] = [torch.rand(16, generator=gen) * 2 - 1
                        for _ in range(k)]
        for b in rhs[f"t{i}"]:
            svc.submit(f"t{i}", b)
    before = arena_mvm.arena_packed_apply.launches
    out = svc.flush_all()
    assert arena_mvm.arena_packed_apply.launches == before + 1
    for mid, cols in rhs.items():
        want = blockamc.execute_arena(svc.solver(mid).arena,
                                      torch.stack(cols, 1).to(cuda),
                                      use_kernel=False)
        assert out[mid].shape == (16, len(cols))
        scaled_close(out[mid], want.cpu().numpy(), 1e-4)
        assert np.isfinite(out[mid]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,nr,s,k,dtype", [
    (3, 5, 37, 7, torch.float32), (2, 4, 64, 33, torch.float64),
    (1, 3, 300, 5, torch.float32), (4, 6, 64, 64, torch.float32),
    # s not a multiple of the 64 x 32 tile (37: rows not 16-byte
    # aligned), k not a multiple of the column slice, in both types;
    # 20 x 64 and 40 x 64 columns take the 16- and 32-column slices
    (2, 3, 100, 20, torch.float32), (2, 3, 100, 20, torch.float64),
    (3, 4, 37, 9, torch.float64), (1, 4, 300, 17, torch.float64),
    (2, 3, 64, 70, torch.float32), (20, 3, 64, 64, torch.float32),
    (40, 2, 64, 64, torch.float32), (40, 2, 96, 50, torch.float64)])
def test_block_tridiag_kernel_matches_plain_version(cuda, b, nr, s, k,
                                                    dtype):
    gen = torch.Generator(device=cuda).manual_seed(s)
    minv = torch.randn((b, nr, s, s), generator=gen, device=cuda,
                       dtype=dtype) * (0.5 / s ** 0.5)
    rhs = torch.randn((b, nr, s, k), generator=gen, device=cuda, dtype=dtype)
    before = banded_solve.block_tridiag_solve.launches
    out = ops.block_tridiag_solve(minv, rhs, gw=0.7)
    torch.cuda.synchronize()
    assert banded_solve.block_tridiag_solve.launches == before + 1
    assert out.dtype == dtype
    scaled_close(out.cpu(), ref.block_tridiag_solve_ref(minv, rhs,
                                                        gw=0.7).cpu(),
                 1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(4, 64), (2, 256)])
def test_block_tridiag_kernel_on_real_crossbars(cuda, b, s):
    """Real factor stacks and residual rhs (identity drive, k = s), as
    phase 6 of chip_smoke.py builds them: the Minv recursion amplifies
    rounding, so the float32 kernel is held to the float64 sweeps, within
    4x the plain float32 sweeps' own error."""
    from repro_torch.physics import nodal
    gen = torch.Generator(device=cuda).manual_seed(s)
    g = torch.rand((b, s, s), generator=gen, device=cuda) * 100e-6
    eye = torch.eye(s, device=cuda).expand(b, s, s)
    minvs, rhs, _ = nodal._mvm_prepare(g, eye, 1.0)
    before = banded_solve.block_tridiag_solve.launches
    out = ops.block_tridiag_solve(minvs, rhs, gw=1.0)
    torch.cuda.synchronize()
    assert banded_solve.block_tridiag_solve.launches == before + 1
    truth = ref.block_tridiag_solve_ref(minvs.double(), rhs.double(),
                                        gw=1.0)

    def rel(x):
        return float((x.double() - truth).abs().max() / truth.abs().max())
    plain = ref.block_tridiag_solve_ref(minvs, rhs, gw=1.0)
    assert rel(out) <= 4 * rel(plain), (rel(out), rel(plain))


@pytest.mark.cuda
def test_block_tridiag_launcher_refuses_bad_input(cuda):
    minv = torch.zeros((2, 3, 8, 8), device=cuda)
    with pytest.raises(ValueError):
        banded_solve.block_tridiag_solve(minv, torch.zeros((2, 3, 8, 4),
                                                           device=cuda,
                                                           dtype=torch.int32),
                                         gw=1.0)
    with pytest.raises(ValueError):
        banded_solve.block_tridiag_solve(minv[:, :2], torch.zeros(
            (2, 3, 8, 4), device=cuda), gw=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        banded_solve.block_tridiag_solve(minv.cpu(), torch.zeros(
            (2, 3, 8, 4)), gw=1.0)


@pytest.mark.cuda
def test_nodal_solver_path_launches_the_banded_kernel(cuda):
    """Programming under the nodal model reads each bucket of arrays out
    once through the kernel; the answers match the plain path's, whose
    write-verify and readouts run the plain sweeps."""
    cfg = AnalogConfig(array_size=16, nonideal=NonidealConfig(
        sigma=0.05, r_wire=1.0, wire_model="nodal", compensate_wire=True,
        p_stuck_on=0.01, p_stuck_off=0.01))
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(256, 64, generator=gen)
    a = (x.T @ x / 256).to(cuda)
    bs = (torch.rand(64, 4, generator=gen) * 2 - 1).to(cuda)
    before = banded_solve.block_tridiag_solve.launches
    solver = blockamc.ProgrammedSolver.program(
        a, torch.Generator().manual_seed(5), cfg, 2, device=cuda)
    # 3 write-verify rounds for each of 16 array pairs, then one readout
    # for the INV bucket and one for each of the two MVM buckets
    assert banded_solve.block_tridiag_solve.launches == before + 16 * 3 + 3
    fplan = blockamc.compile_plan(blockamc.program_system(
        blockamc.partition_system(a, cfg, 2),
        torch.Generator().manual_seed(5), cfg, use_kernel=False))
    plain = blockamc.compile_arena(blockamc.finalize(fplan, cfg,
                                                     use_kernel=False))
    scaled_close(solver.solve_many(bs).cpu(),
                 blockamc.execute_arena(plain, bs, use_kernel=False).cpu(),
                 1e-4)



@pytest.mark.cuda
def test_nodal_gradient_on_the_card_matches_the_host(cuda):
    """d sum(solve(A, b)) / dA under `wire_model="nodal"` on the card
    equals the host's at 1e-4 of max|g| (the host's matches `jax.grad` to
    3.1e-7): with autograd recording, the sweeps take the plain version,
    since the block-Thomas kernel writes outside autograd.  The forward
    without a gradient still launches the kernel."""
    cfg = AnalogConfig(array_size=8, nonideal=NonidealConfig(
        r_wire=1.0, wire_model="nodal"))
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(64, 16, generator=gen)
    a = x.T @ x / 64
    b = torch.rand(16, generator=gen) * 2 - 1
    grads = []
    before = banded_solve.block_tridiag_solve.launches
    for dev in (torch.device("cpu"), cuda):
        ad = a.to(dev).detach().requires_grad_()
        blockamc.solve(ad, b.to(dev), torch.Generator(), cfg, 1) \
            .sum().backward()
        grads.append(ad.grad.cpu())
    assert banded_solve.block_tridiag_solve.launches == before
    assert float(grads[0].abs().max()) > 0
    scaled_close(grads[1], grads[0], 1e-4)
    with torch.no_grad():
        blockamc.solve(a.to(cuda), b.to(cuda), torch.Generator(), cfg, 1)
    assert banded_solve.block_tridiag_solve.launches > before


G0 = 100e-6


@pytest.mark.cuda
@pytest.mark.parametrize("l,b,r,c,bits,dtype", [
    (None, 1, 256, 256, 8, torch.float32),      # the example's check
    (None, 32, 100, 72, None, torch.float32),   # ragged
    (None, 1, 257, 130, 8, torch.float32),      # heavily ragged
    (1, 128, 128, 128, 8, torch.float32),       # L=1 stack
    (3, 5, 70, 130, 8, torch.float32),          # ragged stack
    (4, 64, 64, 64, None, torch.bfloat16),      # bf16
    (2, 64, 96, 40, 8, torch.bfloat16),
    (None, 70, 100, 67, 8, torch.float32),      # odd C: element staging
    (None, 70, 100, 67, None, torch.float32),
    (None, 512, 1024, 1024, 8, torch.float32),  # the bench's row
    (None, 1024, 1024, 256, 8, torch.float32),  # 512 blocks
    (2, 33, 65, 129, None, torch.float32),      # 3xTF32
    (None, 96, 130, 200, 12, torch.float32),    # 12-bit codes: 2 products
    (None, 96, 130, 200, 13, torch.float32),    # 13-bit: 3 products
    (3, 40, 70, 72, 8, torch.bfloat16)])
def test_crossbar_kernel_matches_plain_version(cuda, l, b, r, c, bits,
                                               dtype):
    gen = torch.Generator(device=cuda).manual_seed(r + c)
    lead = () if l is None else (l,)
    v = (torch.rand(lead + (b, c), generator=gen, device=cuda) * 2 - 1
         ).to(dtype)
    gp, gn = ((torch.rand(lead + (r, c), generator=gen, device=cuda) * G0
               ).to(dtype) for _ in range(2))
    kw = dict(g0=G0, dac_bits=bits, adc_bits=bits)
    if l is None:
        counter, entry, plain = (crossbar_mvm.crossbar_mvm, ops.crossbar_mvm,
                                 ref.crossbar_mvm_ref)
    else:
        counter, entry, plain = (crossbar_mvm.crossbar_mvm_batched,
                                 ops.crossbar_mvm_batched,
                                 ref.crossbar_mvm_batched_ref)
    before = counter.launches
    out = entry(v, gp, gn, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == lead + (b, r)
    want = plain(v, gp, gn, **kw).cpu()
    if bits is None:
        scaled_close(out.cpu(), want, 1e-5)
    else:
        one_step_close(out.cpu(), want, 2.0 / (2 ** bits - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("i,j,k,dtype", [
    (128, 128, 128, torch.float32), (256, 128, 384, torch.float32),
    (100, 60, 130, torch.float32), (1, 1, 1, torch.float32),
    (128, 96, 64, torch.bfloat16),
    (1024, 1024, 1024, torch.float32),    # 3xTF32 at the bench's n
    (33, 257, 1000, torch.float32),       # rows of W not 16-byte aligned
    (1024, 1023, 1001, torch.float32),    # 64-row tiles, rows unaligned
    (300, 200, 72, torch.bfloat16),
    (130, 100, 70, torch.bfloat16)])      # bf16 rows not 16-byte aligned
def test_schur_kernel_matches_plain_version(cuda, i, j, k, dtype):
    gen = torch.Generator(device=cuda).manual_seed(i + j + k)
    a4, a3, w = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
                 for shape in ((i, j), (i, k), (k, j)))
    before = schur_gemm.schur_update.launches
    out = ops.schur_update(a4, a3, w)
    torch.cuda.synchronize()
    assert schur_gemm.schur_update.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (i, j)
    scaled_close(out.cpu(), ref.schur_update_ref(a4, a3, w).cpu(), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("vdt,gdt,bits", [
    (torch.bfloat16, torch.float32, None),      # x exact: 2 products
    (torch.float32, torch.bfloat16, None),      # G exact: 2 products
    (torch.float32, torch.bfloat16, 8),         # both exact: 1 product
    (torch.bfloat16, torch.bfloat16, None)])
def test_crossbar_kernel_mixed_types(cuda, vdt, gdt, bits):
    gen = torch.Generator(device=cuda).manual_seed(7)
    v = (torch.rand((3, 100, 150), generator=gen, device=cuda) * 2 - 1
         ).to(vdt)
    gp, gn = ((torch.rand((3, 90, 150), generator=gen, device=cuda) * G0
               ).to(gdt) for _ in range(2))
    kw = dict(g0=G0, dac_bits=bits, adc_bits=bits)
    out = crossbar_mvm.crossbar_mvm_batched(v, gp, gn, **kw)
    torch.cuda.synchronize()
    want = ref.crossbar_mvm_batched_ref(v, gp, gn, **kw).cpu()
    if bits is None:
        scaled_close(out.cpu(), want, 1e-5)
    else:
        one_step_close(out.cpu(), want, 2.0 / (2 ** bits - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [None, 8])
def test_crossbar_kernel_takes_more_arrays_than_grid_z(cuda, bits):
    """70000 tiny arrays: the grid is one-dimensional, so any L runs."""
    gen = torch.Generator(device=cuda).manual_seed(70000)
    v = torch.rand((70000, 2, 5), generator=gen, device=cuda) * 2 - 1
    gp, gn = (torch.rand((70000, 3, 5), generator=gen, device=cuda) * G0
              for _ in range(2))
    kw = dict(g0=G0, dac_bits=bits, adc_bits=bits)
    out = crossbar_mvm.crossbar_mvm_batched(v, gp, gn, **kw)
    torch.cuda.synchronize()
    want = ref.crossbar_mvm_batched_ref(v, gp, gn, **kw).cpu()
    if bits is None:
        scaled_close(out.cpu(), want, 1e-5)
    else:
        one_step_close(out.cpu(), want, 2.0 / (2 ** bits - 1))


@pytest.mark.cuda
def test_crossbar_and_schur_launchers_refuse_bad_input(cuda):
    v = torch.zeros((2, 4, 8), device=cuda)
    g = torch.zeros((2, 3, 8), device=cuda)
    with pytest.raises(ValueError):
        crossbar_mvm.crossbar_mvm_batched(v.double(), g.double(), g.double(),
                                          g0=G0)
    with pytest.raises(ValueError):
        crossbar_mvm.crossbar_mvm_batched(v, g[:, :, :4], g, g0=G0)
    with pytest.raises(ValueError):
        schur_gemm.schur_update(g[0], g[0], g[0])        # (3,8) @ (3,8)
    with pytest.raises(ValueError, match="CUDA"):
        schur_gemm.schur_update(g[0].cpu(), g[0].cpu().T.contiguous(),
                                g[0].cpu())
    for dtype in (torch.float64, torch.float16):     # the entries too
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            ops.crossbar_mvm_batched(v.to(dtype), g, g, g0=G0)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            ops.schur_update(g[0], g[0].T.to(dtype), g[0])


@pytest.mark.cuda
def test_fused_preconditioner_is_one_arena_launch_per_application(cuda):
    """Inside the Krylov loop every application of a fused preconditioner
    over a uniform plan is one arena-kernel launch: the refined solve's
    launches equal its preconditioner applications (the seed, one per
    PCG iteration, none for the exit residual)."""
    cfg = AnalogConfig(array_size=16, opa_gain=1e5)
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(256, 64, generator=gen, dtype=torch.float64)
    a = (x.T @ x / 256).to(cuda)
    prec = AnalogPreconditioner.program(a.float(), gen, cfg, 2, device=cuda)
    assert prec.aplan.program is not None
    b = (torch.rand(64, 3, generator=gen, dtype=torch.float64) * 2 - 1
         ).to(cuda)
    before = arena_mvm.arena_packed_apply.launches
    xs, res = solve_refined(a, b, prec, tol=1e-10, maxiter=200)
    launches = arena_mvm.arena_packed_apply.launches - before
    assert bool(res.converged.all())
    # the seed, the initial z = M r0, then one per iteration of the loop
    assert launches == 2 + int(res.iters.max())
    scaled_close(xs.cpu(), torch.linalg.solve(a, b).cpu(), 1e-8)


def _cuda_solver(cuda, n, asz, stages, cfg=None, seed=None):
    cfg = cfg or AnalogConfig(array_size=asz,
                              nonideal=NonidealConfig(sigma=0.05),
                              opa_gain=1e4)
    gen = torch.Generator().manual_seed(n if seed is None else seed)
    x = torch.randn(4 * n, n, generator=gen)
    return blockamc.ProgrammedSolver.program(x.T @ x / (4 * n), gen, cfg,
                                             stages, device=cuda)


def _grads(run, b, w, stacks=()):
    """d sum(run(b) * w) / d(b, *stacks), b a fresh leaf."""
    b = b.detach().clone().requires_grad_()
    return torch.autograd.grad((run(b) * w).sum(), [b, *stacks])


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_kernel_path_rhs_gradient_matches_plain_path(cuda, packed):
    """The gradient of a solve through the arena kernel: its forward is
    one launch, and d/db equals the plain path's.  (The kernel updates the
    arena outside autograd; a gradient taken straight through it came out
    zero, silently.)"""
    solver = _cuda_solver(cuda, 64, 16, 2)
    gen = torch.Generator().manual_seed(1)
    if packed:
        plan = blockamc.pack_arena_plans(
            [solver.arena, _cuda_solver(cuda, 64, 16, 2, seed=3).arena])
        run = blockamc.execute_arena_packed
        shape = (2, 64, 4)
    else:
        plan, run, shape = solver.arena, blockamc.execute_arena, (64, 4)
    b = (torch.rand(shape, generator=gen) * 2 - 1).to(cuda)
    w = torch.randn(shape, generator=gen).to(cuda)
    before = arena_mvm.arena_packed_apply.launches
    (g_kernel,) = _grads(lambda bb: run(plan, bb), b, w)
    assert arena_mvm.arena_packed_apply.launches == before + 1
    (g_plain,) = _grads(lambda bb: run(plan, bb, use_kernel=False), b, w)
    assert arena_mvm.arena_packed_apply.launches == before + 1
    assert float(g_plain.abs().max()) > 0
    scaled_close(g_kernel.cpu(), g_plain.cpu(), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [None, True])
def test_kernel_path_stack_gradient_matches_plain_path(cuda, use_kernel):
    """A gradient in the operator stacks (the calibration loop's) through
    the kernel path is the plain path's: the forward is one launch and
    the backward recomputes the registers on the plain levels."""
    ap = _cuda_solver(cuda, 64, 16, 2).arena
    stacks = tuple(s.clone().requires_grad_() for s in ap.stacks)
    plan = dataclasses.replace(ap, stacks=stacks)
    gen = torch.Generator().manual_seed(2)
    b = (torch.rand(64, 3, generator=gen) * 2 - 1).to(cuda)
    w = torch.randn(64, 3, generator=gen).to(cuda)
    before = arena_mvm.arena_packed_apply.launches
    got = _grads(lambda bb: blockamc.execute_arena(
        plan, bb, use_kernel=use_kernel), b, w, stacks)
    assert arena_mvm.arena_packed_apply.launches == before + 1
    want = _grads(lambda bb: blockamc.execute_arena(
        plan, bb, use_kernel=False), b, w, stacks)
    for x, y in zip(got, want):
        scaled_close(x.cpu(), y.cpu(), 1e-4)


@pytest.mark.cuda
def test_pcg_fixed_gradient_through_the_fused_preconditioner(cuda):
    """`pcg_fixed` ("differentiable by autograd") with a fused
    preconditioner: each application is one arena launch, and the
    gradient in b equals the one through the finalized (plain) form of
    the same plan."""
    cfg = AnalogConfig(array_size=16, opa_gain=1e5)
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(256, 64, generator=gen, dtype=torch.float64)
    a = (x.T @ x / 256).to(cuda)
    fused = AnalogPreconditioner.program(a.float(), gen, cfg, 2,
                                         device=cuda)
    plain = AnalogPreconditioner(fused.fin, mode="reference")
    b = (torch.rand(3, 64, generator=gen, dtype=torch.float64) * 2 - 1
         ).to(cuda)
    w = torch.randn(3, 64, generator=gen, dtype=torch.float64).to(cuda)

    def run(prec):
        return lambda bb: pcg_fixed(lambda v: v @ a.T, bb, precond=prec,
                                    iters=4).x
    before = arena_mvm.arena_packed_apply.launches
    (g_fused,) = _grads(run(fused), b, w)
    assert arena_mvm.arena_packed_apply.launches == before + 5
    (g_plain,) = _grads(run(plain), b, w)
    scaled_close(g_fused.cpu(), g_plain.cpu(), 1e-4)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_tensors_that_require_grad_on_the_card(cuda):
    args = [torch.from_numpy(x).to(cuda) for x in tile_program()]
    before = arena_mvm.arena_packed_apply.launches
    with pytest.raises(ValueError, match="outside autograd"):
        ops.arena_packed_apply(args[0].clone().requires_grad_(), *args[1:])
    with pytest.raises(ValueError, match="outside autograd"):
        ops.arena_level_apply(args[0][0], args[1][0].requires_grad_(),
                              *args[2:])
    minv = torch.eye(8, device=cuda).expand(2, 3, 8, 8).contiguous()
    rhs = torch.ones(2, 3, 8, 4, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="outside autograd"):
        ops.block_tridiag_solve(minv, rhs, gw=1.0)
    assert arena_mvm.arena_packed_apply.launches == before
    # the other four wrappers refuse on the card too, before any launch
    counters = [crossbar_mvm.crossbar_mvm, crossbar_mvm.crossbar_mvm_batched,
                schur_gemm.schur_update, flash_attention.flash_attention]
    launches = [f.launches for f in counters]
    v = torch.rand(4, 8, device=cuda)
    g = torch.rand(3, 8, device=cuda)
    with pytest.raises(ValueError, match="outside autograd"):
        ops.crossbar_mvm(v.requires_grad_(), g, g, g0=G0)
    with pytest.raises(ValueError, match="outside autograd"):
        ops.crossbar_mvm_batched(v.detach()[None], g[None].requires_grad_(),
                                 g[None], g0=G0)
    with pytest.raises(ValueError, match="outside autograd"):
        ops.schur_update(torch.rand(8, 8, device=cuda),
                         g.T.contiguous().requires_grad_(), g)
    q = torch.rand(2, 128, 64, device=cuda)
    with pytest.raises(ValueError, match="outside autograd"):
        ops.flash_attention(q, q.clone().requires_grad_(), q)
    assert [f.launches for f in counters] == launches


@pytest.mark.cuda
def test_repaired_solver_splice_matches_a_fresh_compile(cuda):
    """Block repair on the card, of a plan aged to 50 s with the
    repaired slices read at the same age: the spliced arena plan equals a
    fresh finalize / compile_arena of the spliced flat plan (at
    float tolerance: batched LU on the card may differ in the last bits
    between a subset and the whole stack), and the repaired solver's
    kernel path answers as the plain path does."""
    cfg = AnalogConfig(array_size=16, opa_gain=1e4, nonideal=NonidealConfig(
        sigma=0.02, r_wire=1.0, compensate_wire=True, wv_iters=3,
        drift_nu=0.05))
    solver = _cuda_solver(cuda, 64, 16, 2, cfg=cfg).aged(50.0)
    refs = [r.ref for r in solver.block_map()]
    rep = solver.repaired(refs[::3], torch.Generator().manual_seed(5),
                          drift_t=50.0)
    fresh = blockamc.compile_arena(blockamc.finalize(rep.flat, cfg,
                                                     drift_t=50.0))
    assert rep.arena.program is not None
    scaled_close(rep.arena.program[0].cpu(), fresh.program[0].cpu(), 1e-5)
    for x, y in zip(rep.arena.stacks, fresh.stacks):
        scaled_close(x.cpu(), y.cpu(), 1e-5)
    gen = torch.Generator().manual_seed(6)
    b = (torch.rand(64, 4, generator=gen) * 2 - 1).to(cuda)
    before = arena_mvm.arena_packed_apply.launches
    xs = rep.solve_many(b)
    assert arena_mvm.arena_packed_apply.launches == before + 1
    scaled_close(xs.cpu(), blockamc.execute_arena(
        fresh, b, use_kernel=False).cpu(), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,dtype,causal", [
    (4, 128, 128, torch.float32, True),
    (3, 200, 128, torch.float32, True),       # ragged S
    (2, 1000, 64, torch.float32, True),
    (2, 256, 64, torch.float32, False),
    (5, 77, 64, torch.float32, True),         # one partial tile
    (8, 512, 128, torch.bfloat16, True),
    (2, 300, 64, torch.bfloat16, True),
    # the bf16 tensor-core kernel: partial and single tiles, both head
    # dims, full attention and the longest causal walk
    (1, 1, 64, torch.bfloat16, True),
    (1, 1, 128, torch.bfloat16, True),
    (1, 64, 64, torch.bfloat16, True),
    (1, 64, 128, torch.bfloat16, True),
    (1, 127, 64, torch.bfloat16, True),
    (1, 127, 128, torch.bfloat16, True),
    (1, 129, 64, torch.bfloat16, True),
    (1, 129, 128, torch.bfloat16, True),
    (1, 1000, 64, torch.bfloat16, True),
    (1, 1000, 128, torch.bfloat16, True),
    (2, 256, 128, torch.bfloat16, False),
    (2, 4096, 128, torch.bfloat16, True),
])
def test_flash_kernel_matches_plain_version(cuda, bh, s, d, dtype, causal):
    gen = torch.Generator(device=cuda).manual_seed(bh * s + d)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device=cuda
                           ).to(dtype) for _ in range(3))
    before = flash_attention.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    plain = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal=causal)
    if dtype == torch.float32:
        scaled_close(out.cpu(), plain.cpu(), 1e-5)
    else:
        bf16_rounding_close(out.float().cpu(), plain.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 129, 1000])
def test_f32_flash_kernel_at_ragged_lengths(cuda, s, d, causal):
    """The float32 (3xTF32) instance at lengths that are not a multiple of
    its 64-row query tiles or 32-key tiles, both head dims, causal and
    full (through the kernel's launcher: the public entry keeps the JAX
    wrapper's S % 128 rule for full attention)."""
    gen = torch.Generator(device=cuda).manual_seed(s * d + causal)
    q, k, v = (torch.randn((3, s, d), generator=gen, device=cuda)
               for _ in range(3))
    before = flash_attention.flash_attention.launches
    out = flash_attention.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    scaled_close(out.cpu(), ref.flash_attention_ref(q, k, v,
                                                    causal=causal).cpu(),
                 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_more_heads_than_grid_y(cuda, dtype):
    """BH = 70000 (batch x heads past gridDim.y's 65535; glm4-9b at batch
    2048 has 65536): one launch of a one-dimensional grid."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((70000, 5, 64), generator=gen, device=cuda
                           ).to(dtype) for _ in range(3))
    before = flash_attention.flash_attention.launches
    out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    plain = ref.flash_attention_ref(q.float(), k.float(), v.float())
    if dtype == torch.float32:
        scaled_close(out.cpu(), plain.cpu(), 1e-5)
    else:
        bf16_rounding_close(out.float().cpu(), plain.cpu())


@pytest.mark.cuda
def test_flash_launcher_refuses_bad_input(cuda):
    q = torch.zeros((2, 128, 64), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q[..., :32].contiguous(),
                                        q[..., :32].contiguous(),
                                        q[..., :32].contiguous())
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q[:, :64].contiguous(), q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), q, q)
    # misaligned views are copied by the public entry, refused below it
    buf = torch.randn(2 * 128 * 64 + 1, device=cuda)
    odd = buf[1:].view(2, 128, 64)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention.flash_attention(odd, odd, odd)
    scaled_close(ops.flash_attention(odd, odd, odd).cpu(),
                 ref.flash_attention_ref(odd, odd, odd).cpu(), 1e-5)


@pytest.mark.cuda
def test_prefill_launches_the_flash_kernel_once_a_layer(cuda):
    """The model's default route on the card is the kernel: one launch per
    attention layer of a prefill, none for `use_flash=False`, and the two
    routes' logits agree in float32."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    cfg = dataclasses.replace(get_config("glm4-9b"), n_layers=3,
                              d_model=256, n_heads=4, kv_heads=2,
                              head_dim=64, d_ff=512, vocab=1000,
                              param_dtype="float32", compute_dtype="float32")
    params = tr.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 150), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    before = flash_attention.flash_attention.launches
    logits, cache = tr.prefill(params, cfg, tokens=toks, cache_len=160)
    assert flash_attention.flash_attention.launches == before + cfg.n_layers
    plain, _ = tr.prefill(params, cfg, tokens=toks, cache_len=160,
                          use_flash=False)
    assert flash_attention.flash_attention.launches == before + cfg.n_layers
    scaled_close(logits.cpu(), plain.cpu(), 2e-4)
    full, _ = tr.forward(params, cfg, tokens=toks)
    assert flash_attention.flash_attention.launches == \
        before + 2 * cfg.n_layers
    scaled_close(full[:, -1].cpu(), logits.cpu(), 2e-4)


@pytest.mark.cuda
def test_lm_gradient_on_the_card_matches_the_chunked_path(cuda):
    """A gradient through `transformer.forward` on the card with the
    default route equals the chunked path's for every leaf, wq, wk and wv
    included: the route takes the chunked path whenever autograd records
    (the kernel writes outside autograd, so its route would leave the
    projections without a gradient).  No flash launch while it records.
    2-layer float32, glm4-9b's layout (grouped KV heads of dim 128, so
    the kernel has the case) at a narrower width."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr

    def tree_map(fn, tree):     # the parent tree has no repro_torch.tree
        if isinstance(tree, dict):
            return {k: tree_map(fn, v) for k, v in tree.items()}
        return fn(tree)
    cfg = dataclasses.replace(get_config("glm4-9b"), n_layers=2,
                              d_model=512, n_heads=8, kv_heads=2,
                              head_dim=128, d_ff=1024, vocab=1000,
                              param_dtype="float32", compute_dtype="float32")
    params = tr.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 256), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    grads = {}
    before = flash_attention.flash_attention.launches
    for use_flash in (None, False):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        logits, _ = tr.forward(leaves, cfg, tokens=toks, use_flash=use_flash)
        (logits.float().square().mean()).backward()
        grads[use_flash] = tree_map(lambda p: p.grad, leaves)
    for name in ("wq", "wk", "wv", "wo"):
        g = grads[None]["blocks"]["b0"]["mix"][name]
        assert g is not None and float(g.abs().max()) > 0, name

    def pairs(a, b):
        if isinstance(a, dict):
            for k in a:
                yield from pairs(a[k], b[k])
        else:
            yield a, b
    for got, want in pairs(grads[None], grads[False]):
        scaled_close(got.cpu(), want.cpu(), 1e-4)
    assert flash_attention.flash_attention.launches == before
    # the training loss's gradient through the default route, likewise
    from repro_torch.train.train_step import value_and_grad
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    _, _, g_train = value_and_grad(params, batch, cfg, "dots")
    assert float(g_train["blocks"]["b0"]["mix"]["wk"].abs().max()) > 0


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_host(cuda):
    """One float32 `make_train_step` (two microbatches, remat "dots") on
    the card against the same step on the host from the same parameters:
    loss within 1e-5 relative, every gradient leaf within 1e-4 of its
    max|g| (TF32 off)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tr
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step,
                                              value_and_grad)
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=2,
                              d_model=256, n_heads=4, kv_heads=4,
                              d_ff=512, vocab=1000, param_dtype="float32",
                              compute_dtype="float32")
    run = RunConfig(model=cfg, mode="train", seq_len=128, global_batch=4,
                    microbatch=2)
    state, opt = init_train_state(torch.Generator().manual_seed(0), cfg,
                                  run, AdamW(lr=1e-3))
    batch = SyntheticLM(cfg, run, seed=0, device="cpu").batch(0)
    on_card = tree_map(lambda x: x.to(cuda), state.params)
    card_batch = {k: v.to(cuda) for k, v in batch.items()}
    loss_h, _, g_h = value_and_grad(state.params, batch, cfg, "dots")
    loss_c, _, g_c = value_and_grad(on_card, card_batch, cfg, "dots")
    assert abs(float(loss_c) - float(loss_h)) <= 1e-5 * abs(float(loss_h))

    def pairs(a, b):
        if isinstance(a, dict):
            for k in a:
                yield from pairs(a[k], b[k])
        else:
            yield a, b
    for got, want in pairs(g_c, g_h):
        scaled_close(got.cpu(), want, 1e-4)
    step = make_train_step(cfg, run, opt)
    _, m_h = step(state, batch)
    card_state = type(state)(on_card, type(state.opt)(
        state.opt.step.to(cuda), tree_map(lambda x: x.to(cuda), state.opt.m),
        tree_map(lambda x: x.to(cuda), state.opt.v)))
    _, m_c = step(card_state, card_batch)
    for key in ("loss", "grad_norm"):
        assert abs(float(m_c[key]) - float(m_h[key])) <= \
            1e-5 * abs(float(m_h[key])), key


@pytest.mark.cuda
def test_analog_preconditioner_is_one_arena_launch_a_program(
        cuda, monkeypatch):
    """`BlockAMCPrecond(use_analog=True)` on the card: every inverse of
    the Denman-Beavers refresh programs a uniform plan and seeds its CG
    with one arena launch (analog_precond=False), so a refresh launches
    2 * db_iters times; each seed precond(eye) equals the plain arena path
    on the same plan (1e-5 of max|x|: CG would hide a wrong seed); the
    result matches the digital refresh."""
    from repro_torch.optim import blockamc_precond
    from repro_torch.optim.blockamc_precond import BlockAMCPrecond
    seeds = []

    class Recorded(AnalogPreconditioner):
        def __call__(self, v):
            out = super().__call__(v)
            seeds.append((self.aplan, v, out))
            return out

    monkeypatch.setattr(blockamc_precond, "AnalogPreconditioner", Recorded)
    gen = torch.Generator().manual_seed(3)
    g = torch.randn(512, 128, generator=gen).to(cuda)
    outs = []
    for analog in (False, True):
        pre = BlockAMCPrecond(damping=5e-2, db_iters=3, use_analog=analog,
                              refine_iters=8)
        state = pre.update_stats({"w": g}, pre.init({"w": g}))
        before = arena_mvm.arena_packed_apply.launches
        state = pre.refresh_inverses(state)
        launches = arena_mvm.arena_packed_apply.launches - before
        assert launches == (2 * pre.db_iters if analog else 0)
        outs.append(pre.precondition({"w": g}, state)["w"])
    assert len(seeds) == 2 * pre.db_iters
    for aplan, eye, seed in seeds:        # row j answers column j
        plain = blockamc.execute_arena(aplan, eye.T, use_kernel=False).T
        scaled_close(seed.cpu(), plain.cpu(), 1e-5)
    rel = float(torch.linalg.norm(outs[1] - outs[0])
                / torch.linalg.norm(outs[0]))
    assert rel < 0.05


# ---------------------------------------------- the serving stack ---------

def _serving_matrix(seed, n=128):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(4 * n, n, generator=g)
    return (x.T @ x / (4 * n)).numpy()


def _serving_cfg():
    return AnalogConfig(array_size=32, nonideal=NonidealConfig(sigma=0.05))


@pytest.mark.cuda
def test_three_engines_flush_at_once_from_their_worker_threads(cuda):
    """Three engines on one card, each flushing a packed bucket from its
    own worker thread at the same moment: every answer matches the plain
    path of its plan, and each flush launched the arena kernel."""
    from repro_torch import keys
    from repro_torch.serve import AsyncSolverEngine
    engines = [AsyncSolverEngine(SolverService(_serving_cfg(), stages=2),
                                 max_batch=64, flush_interval=60.0,
                                 name=f"e{e}") for e in range(3)]
    for e, eng in enumerate(engines):
        for i in range(4):
            eng.program(f"m{i}", _serving_matrix(10 * e + i),
                        keys.fold_in(keys.PRNGKey(e), i))
    rng = np.random.default_rng(0)
    before = arena_mvm.arena_packed_apply.launches
    futs = []
    for eng in engines:
        eng.start()
    try:
        for eng in engines:
            for j in range(8):
                b = rng.uniform(-1, 1, 128).astype(np.float32)
                futs.append((eng, f"m{j % 4}", b,
                             eng.submit(f"m{j % 4}", b)))
        for eng in engines:
            eng.flush_now()
        results = [(eng, mid, b, f.result(timeout=120))
                   for eng, mid, b, f in futs]
    finally:
        for eng in engines:
            eng.stop(timeout=60)
    assert arena_mvm.arena_packed_apply.launches - before >= 3
    for eng, mid, b, res in results:
        assert eng.stats.dispatches == 1 and res.mode == "analog"
        plain = blockamc.execute_arena(
            eng.service.solver(mid).arena,
            torch.from_numpy(b).to(cuda), use_kernel=False)
        scaled_close(res.x, plain.cpu(), 1e-4)


@pytest.mark.cuda
def test_replicated_programming_is_bit_identical_on_the_card(cuda):
    from repro_torch import keys
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.serve import ReplicatedSolverFleet
    fleet = ReplicatedSolverFleet(
        lambda: SolverService(_serving_cfg(), stages=2), 3,
        engine_kw=dict(max_batch=4, flush_interval=0.005))
    assert {r.engine.device for r in fleet._replicas} == {
        torch.device("cuda", torch.cuda.current_device())}
    with fleet:
        for i in range(2):
            fleet.program(f"m{i}", _serving_matrix(i),
                          keys.fold_in(keys.PRNGKey(3), i))
        for i in range(2):
            trees = [list(flatten({"fin": s.finalized, "arena": s.arena}))
                     for s in (r.engine.service.solver(f"m{i}")
                               for r in fleet._replicas)]
            for leaves in zip(*trees):
                assert len({k for k, _ in leaves}) == 1
                assert all(torch.equal(leaves[0][1], x) for _, x in leaves)
                assert leaves[0][1].device.type == "cuda"
        b = np.ones(128, np.float32)
        res = fleet.submit("m0", b).result(timeout=60)
        plain = blockamc.execute_arena(
            fleet._replicas[0].engine.service.solver("m0").arena,
            torch.from_numpy(b).to(cuda), use_kernel=False)
        scaled_close(res.x, plain.cpu(), 1e-4)


@pytest.mark.cuda
def test_store_saved_on_the_card_restores_on_the_card(cuda, tmp_path):
    """A plan programmed on the card, saved, restored onto the card and
    installed: its canary passes the trip calibrated when it was
    programmed, and it answers bit for bit like the saved plan."""
    from repro_torch import keys
    from repro_torch.checkpoint import ProgramStore
    from repro_torch.serve import AsyncSolverEngine
    a = _serving_matrix(5)
    key = keys.PRNGKey(5)
    first = AsyncSolverEngine(SolverService(_serving_cfg(), stages=2))
    first.program("m", a, key)
    solver = first.service.solver("m")
    store = ProgramStore(str(tmp_path))
    store.save("m", solver, a, key, first.service.signature("m"),
               extra={"trip": first.matrix_trip("m")})
    second = AsyncSolverEngine(SolverService(_serving_cfg(), stages=2))
    restored, meta = store.restore("m", solver, a, key,
                                   first.service.signature("m"))
    assert restored.device.type == "cuda"
    second.install("m", restored, a, key, meta["trip"])   # canary passes
    assert second.health()["canary"]["m"] <= meta["trip"]
    b = torch.linspace(-1, 1, 128, device=cuda)
    before = arena_mvm.arena_packed_apply.launches
    assert torch.equal(restored.solve(b), solver.solve(b))
    assert arena_mvm.arena_packed_apply.launches == before + 2


def _one_rank_mesh(cuda):
    """A one-rank NCCL ("data", "model") mesh; the caller destroys the
    group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    assert not dist.is_initialized()
    return make_host_mesh(1, 1, device=cuda)


@pytest.mark.cuda
def test_sharded_prefill_on_the_card_matches_the_host(cuda):
    """Phase 18 (a) at 2 layers in float32: glm4-9b's layout (grouped KV
    heads of dim 128) at a narrower width, parameters laid out by
    `make_param_shardings` under `make_policy` on a one-rank NCCL mesh;
    the prefill's logits (one flash launch a layer, on the local heads)
    within 2e-4 of max|logit| of the host's unsharded prefill."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import transformer as tr
    from repro_torch.sharding import api, partition
    cfg = dataclasses.replace(get_config("glm4-9b"), n_layers=2,
                              d_model=512, n_heads=8, kv_heads=2,
                              head_dim=128, d_ff=1024, vocab=1000,
                              param_dtype="float32", compute_dtype="float32")
    run = RunConfig(model=cfg, mode="prefill", seq_len=256, global_batch=4)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (4, 256),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = tr.prefill(params, cfg, tokens=toks)
    mesh = _one_rank_mesh(cuda)
    try:
        on_card = _to(params, cuda)
        with api.policy_scope(partition.make_policy(mesh, cfg, run)), \
                torch.no_grad():
            placed = partition.distribute(on_card, partition
                                          .make_param_shardings(
                                              on_card, mesh, False))
            before = flash_attention.flash_attention.launches
            got, _ = tr.prefill(placed, cfg, tokens=partition.distribute(
                toks.to(cuda), partition.batch_sharding(mesh, cfg, run)))
            torch.cuda.synchronize()
            assert flash_attention.flash_attention.launches == before + 2
            assert api.is_dtensor(got)
            got = api.whole(got)
    finally:
        dist.destroy_process_group()
    scaled_close(got.cpu(), want, 2e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.cuda
def test_sharded_gradients_on_the_card_match_the_host(cuda):
    """Phase 18 (b) at 2 layers in float32: stablelm-1.6b's layout at a
    narrower width, FSDP, the parameters laid out by
    `make_param_shardings` on a one-rank NCCL mesh under the policy;
    loss within 1e-5 relative and every gradient leaf within 1e-4 of its
    max|g| of the host's unsharded `value_and_grad`, with no flash
    launch (autograd takes the chunked path)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tr
    from repro_torch.sharding import api, partition
    from repro_torch.train.train_step import value_and_grad
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=2,
                              d_model=256, n_heads=4, kv_heads=4,
                              d_ff=512, vocab=1000, param_dtype="float32",
                              compute_dtype="float32")
    run = RunConfig(model=cfg, mode="train", seq_len=128, global_batch=4,
                    microbatch=2, fsdp=True)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg)
    batch = SyntheticLM(cfg, run, seed=0, device="cpu").batch(0)
    loss_h, _, g_h = value_and_grad(params, batch, cfg, "dots")
    mesh = _one_rank_mesh(cuda)
    try:
        on_card = _to(params, cuda)
        with api.policy_scope(partition.make_policy(mesh, cfg, run)):
            placed = partition.distribute(on_card, partition
                                          .make_param_shardings(
                                              on_card, mesh, True))
            bsh = partition.batch_sharding(mesh, cfg, run)
            before = flash_attention.flash_attention.launches
            loss_c, _, g_c = value_and_grad(
                placed, {k: partition.distribute(v.to(cuda), bsh)
                         for k, v in batch.items()}, cfg, "dots")
            torch.cuda.synchronize()
            assert flash_attention.flash_attention.launches == before
            loss_c = float(api.whole(loss_c))
            g_c = _whole_tree(g_c, api)
    finally:
        dist.destroy_process_group()
    assert abs(loss_c - float(loss_h)) <= 1e-5 * abs(float(loss_h))

    def pairs(a, b):
        if isinstance(a, dict):
            for k in a:
                yield from pairs(a[k], b[k])
        else:
            yield a, b
    for got, want in pairs(g_c, g_h):
        scaled_close(got.cpu(), want, 1e-4)


def _whole_tree(tree, api):
    if isinstance(tree, dict):
        return {k: _whole_tree(v, api) for k, v in tree.items()}
    return api.whole(tree)
