"""The arena kernel's plain version and wrappers against the JAX package,
on a CPU host, where the kernel wrappers run the plain version (the CUDA
kernel itself is held against it on the card in test_torch_cuda.py).

Tolerances: the port's plain version against the JAX oracle and the JAX
Pallas kernel (interpret mode) at 1e-5 of max|out| - the same tile
program, with f32 matmuls that may sum in another order.  (The JAX
package's own kernel-vs-jnp test at atol 1e-7 fails on exactly that
rounding: 9.5e-7 absolute at 1.8e-7 relative.)  With 6-bit converters
a reassociated sum could land an ADC output one step away; these inputs
stay clear of that and must agree to the same bound.
"""
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels._launch import column_slice
from repro_torch.kernels import arena_mvm as tarena
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from _torch_parity import scaled_close, t, tile_program


@pytest.mark.parametrize("bits", [None, 6])
def test_arena_packed_ref_matches_jax_oracle_and_pallas(bits):
    args = tile_program()
    kw = dict(dac_bits=bits, adc_bits=bits, fullscale=1.0)
    out = tref.arena_packed_ref(*(t(x) for x in args), **kw)
    scaled_close(out, jref.arena_packed_ref(*map(jnp.asarray, args), **kw),
                 1e-5)
    scaled_close(out, jops.arena_packed_apply(*map(jnp.asarray, args),
                                              interpret=True, **kw), 1e-5)


def test_arena_level_ref_is_the_single_instance_case():
    arena, ops, *meta = tile_program(m=1)
    out = tref.arena_level_ref(t(arena[0]), t(ops[0]), *map(t, meta))
    scaled_close(out, jref.arena_level_ref(jnp.asarray(arena[0]),
                                           jnp.asarray(ops[0]),
                                           *map(jnp.asarray, meta)), 1e-5)


def test_cpu_wrappers_run_the_plain_version_and_keep_dtype():
    args = [t(x) for x in tile_program()]
    before = tarena.arena_packed_apply.launches
    out = tops.arena_packed_apply(*args, dac_bits=6, adc_bits=6)
    assert torch.equal(out, tref.arena_packed_ref(*args, dac_bits=6,
                                                  adc_bits=6))
    wide = tops.arena_packed_apply(args[0].double(), *args[1:])
    assert wide.dtype == torch.float64
    lvl = tops.arena_level_apply(args[0][0], args[1][0], *args[2:])
    assert torch.equal(lvl, tref.arena_level_ref(args[0][0], args[1][0],
                                                 *args[2:]))
    assert tarena.arena_packed_apply.launches == before


def test_kernel_launcher_refuses_host_tensors():
    args = [t(x) for x in tile_program()]
    with pytest.raises(ValueError, match="CUDA"):
        tarena.arena_packed_apply(*args)


def test_column_slice_fills_the_card():
    sxm = 132                                           # H100 SXM
    assert column_slice(16, 8, sxm) == 1            # main path: 128 blocks
    assert column_slice(128, 128, sxm) == 32        # 512 blocks
    assert column_slice(1, 5, sxm) == 1
    assert column_slice(8, 256, sxm) == 8           # 256 blocks
    assert column_slice(8, 256, 114) == 16          # H100 PCIe: 128 blocks
    assert column_slice(8, 256, sxm, fits=lambda kb: kb <= 4) == 4
    for m, k in [(1, 1), (4, 32), (16, 8), (128, 128), (3, 1000)]:
        kb = column_slice(m, k, sxm)
        assert kb in (1, 2, 4, 8, 16, 32)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["arena_mvm"])
    # the library name tracks the source and flags, inside the package
    path = _build.library_path("arena_mvm")
    assert path.parent == _build.BUILD and path.name.startswith(
        "libarena_mvm-")
