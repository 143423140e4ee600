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
kernel to a float64 evaluation there).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import blockamc
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.nonideal import NonidealConfig
from repro_torch.kernels import arena_mvm
from repro_torch.kernels import banded_solve
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.serve import SolverService
from _torch_parity import quantized_close, scaled_close, tile_program


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
    (1, 3, 300, 5, torch.float32), (4, 6, 64, 64, torch.float32)])
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
