"""The kernels' plain versions and wrappers against the JAX package, on a
CPU host, where the kernel wrappers run the plain version (the CUDA
kernels themselves are held against it on the card in test_torch_cuda.py):
the arena tile program, the crossbar MVM (single and stacked), the
Schur update and flash attention.

Tolerances: the port's plain version against the JAX oracle and the JAX
Pallas kernel (interpret mode) at 1e-5 of max|out| - the same tile
program, with f32 matmuls that may sum in another order.  (The JAX
package's own kernel-vs-jnp test at atol 1e-7 fails on exactly that
rounding: 9.5e-7 absolute at 1.8e-7 relative.)  With 6-bit converters
a reassociated sum could land an ADC output one step away; these inputs
stay clear of that and must agree to the same bound.  The crossbar's plain
version against the JAX oracle and the Pallas kernel: 1e-5 of max|out|
with ideal converters; with 8-bit converters an output within rounding of
a bin edge may land one ADC step away (`one_step_close`).  The Schur
update: 1e-5 of max|out|.  Flash attention: the reference tests' own
tolerances (`test_kernels.py::test_flash_attention_*`): 2e-5 (rtol and
atol) in float32 and 3e-2 in bfloat16 - the port's plain version, the CPU
wrapper, the JAX oracle and the JAX Pallas kernel (interpret mode) are all
one softmax attention summed in another order or blocked differently.
"""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels._launch import column_slice
from repro_torch.kernels import arena_mvm as tarena
from repro_torch.kernels import crossbar_mvm as txbar
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import schur_gemm as tschur
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from _torch_parity import (bf16_rounding_close, one_step_close, scaled_close,
                           t, tile_program)


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


def _arena_smem_bytes(s, t, j, c, kb, stages):
    """`csrc/arena_mvm.cu::smem_bytes` as this test takes it: a ring of
    `stages` 64-row panels (plus 3 floats of alignment, rounded to 32
    floats), its mbarriers, the window metadata, the arena slice and the
    DAC'd tile (rows padded to the c-lanes)."""
    slot = -(-(64 * c + 3) // 32) * 32
    v_stride = c + (32 // kb - c) % 32
    return (128 + 4 * stages * slot + 16 * stages
            + 4 * (2 * t * j + 2 * t) + 4 * (s * kb + kb * v_stride))


def test_arena_plan_picks_the_instance_from_shapes():
    """The arena kernel's instance, column slice and ring depth, from the
    shapes alone (H100 SXM: 132 SMs, 227 KB of shared memory a block)."""
    sxm, optin = 132, 232448

    def plan(m, s, k, t_, c, j, need=_arena_smem_bytes):
        return tarena.plan(m, s, k, t_, c, j, sxm, optin, need)
    # (M, S, K, T, C, J): chip_smoke.py phase 3's cases, phase 5's levels
    assert plan(16, 704, 8, 23, 64, 3) == ("smem", 1, 3)
    assert plan(128, 704, 128, 23, 64, 3) == ("smem", 16, 3)
    assert plan(4, 2816, 32, 23, 256, 3) == ("smem", 1, 3)
    assert plan(1, 2816, 8, 64, 64, 3) == ("smem", 1, 3)
    assert plan(1, 2816, 8, 1, 256, 3) == ("smem", 1, 3)
    # an arena too tall for shared memory even one column wide
    assert plan(1, 60000, 2, 5, 8, 3) == ("global", 1, 0)
    assert plan(64, 60000, 64, 5, 8, 3) == \
        ("global", column_slice(64, 64, sxm), 0)
    for m, s, k, t_, c, j in [(16, 704, 8, 23, 64, 3), (3, 300, 37, 23, 33,
                                                        3)]:
        inst, kb, stages = plan(m, s, k, t_, c, j)
        assert _arena_smem_bytes(s, t_, j, c, kb, stages) <= optin
        assert 2 <= stages <= 3 and kb <= 16
    # two ring slots where three do not fit; a narrower slice where a
    # wider one does not
    def ring(s, t_, j, c, kb, stages):
        return 1000 * stages + 100 * kb
    assert plan(128, 704, 128, 23, 64, 3, ring) == ("smem", 16, 3)
    assert tarena.plan(128, 704, 128, 23, 64, 3, sxm, 2500, ring) == \
        ("smem", 4, 2)
    assert tarena.plan(128, 704, 128, 23, 64, 3, sxm, 2000, ring) == \
        ("global", 32, 0)


def test_block_thomas_column_slice_is_the_narrowest_one_wave():
    from repro_torch.kernels.banded_solve import column_slice as slice_of
    sxm, optin = 132, 232448                        # H100 SXM, 227 KB

    def need(s, kb):                                # ring + two carries
        return 1024 + 6 * 16384 + 2 * 2 * -(-s // 32) * kb * 128 + 96
    assert slice_of(4, 64, 64, sxm, optin, need) == 8      # solver path
    assert slice_of(8, 256, 256, sxm, optin, need) == 16   # 128 blocks
    assert slice_of(40, 64, 64, sxm, optin, need) == 32    # > 1 wave
    assert slice_of(1, 5, 37, sxm, optin, need) == 8
    assert slice_of(40, 256, 300, sxm, optin, need) == 16  # 32 too big
    assert slice_of(1, 64, 1100, sxm, optin, need) == 0    # none fits


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["arena_mvm"])
    # the library name tracks the source and flags, inside the package
    path = _build.library_path("arena_mvm")
    assert path.parent == _build.BUILD and path.name.startswith(
        "libarena_mvm-")


def test_concurrent_first_loads_build_once_and_load_once(monkeypatch,
                                                         tmp_path):
    """Serving replicas reach a cold build directory from several worker
    threads at once: one compile, one load, one library path for all of
    them, and no temporary file left behind.  A stand-in compiler sleeps
    before it writes its output, so every thread is inside `load` while
    the first compile runs."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "demo.cu").write_text("// stand-in source\n")
    calls = tmp_path / "compiles.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"open({str(calls)!r}, 'a').write(out + '\\n')\n"
        "time.sleep(0.5)\n"
        "open(out, 'wb').write(b'library')\n")
    nvcc.chmod(0o755)
    loaded = []
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", build)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: loaded.append(path) or ("lib", path))
    gate = threading.Barrier(4)
    results, errors = [], []

    def first_call():
        gate.wait(timeout=30)
        try:
            results.append(_build.load("demo"))
        except Exception as e:                       # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=first_call) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert not errors, errors
    assert len(calls.read_text().splitlines()) == 1     # one compile
    assert loaded == [str(_build.library_path("demo"))]   # one load
    assert len(results) == 4 and len(set(results)) == 1
    assert sorted(p.name for p in build.iterdir()) == [
        _build.library_path("demo").name]                # no .tmp left


# ------------------------------ crossbar_mvm ------------------------------

G0 = 100e-6


def _xbar_inputs(lead, b, r, c, seed=0):
    """v uniform in [-1, 1] (lead..., B, C); gpos, gneg uniform in [0, G0]
    (lead..., R, C); float32 numpy."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, size=lead + (b, c)).astype(np.float32)
    gp = (rng.uniform(0, 1, size=lead + (r, c)) * G0).astype(np.float32)
    gn = (rng.uniform(0, 1, size=lead + (r, c)) * G0).astype(np.float32)
    return v, gp, gn


def _xbar_close(out, want, bits):
    if bits is None:
        scaled_close(out, want, 1e-5)
    else:
        one_step_close(out, want, 2.0 / (2 ** bits - 1))


@pytest.mark.parametrize("b,r,c", [(128, 128, 128), (128, 256, 384),
                                   (256, 128, 256), (32, 100, 72),
                                   (1, 257, 130)])
@pytest.mark.parametrize("bits", [None, 8])
def test_crossbar_ref_matches_jax_oracle_and_pallas(b, r, c, bits):
    v, gp, gn = _xbar_inputs((), b, r, c, seed=b + r + c)
    kw = dict(g0=G0, dac_bits=bits, adc_bits=bits)
    out = tref.crossbar_mvm_ref(t(v), t(gp), t(gn), **kw)
    assert out.shape == (b, r) and out.dtype == torch.float32
    jin = [jnp.asarray(x) for x in (v, gp, gn)]
    _xbar_close(out, jref.crossbar_mvm_ref(*jin, **kw), bits)
    _xbar_close(out, jops.crossbar_mvm(*jin, interpret=True, **kw), bits)


@pytest.mark.parametrize("dac,adc", [(8, None), (None, 8), (6, 10)])
def test_crossbar_ref_converter_placement_matches_jax(dac, adc):
    """DAC before the sum, ADC after the complete sum."""
    v, gp, gn = _xbar_inputs((), 128, 128, 256, seed=3)
    kw = dict(g0=G0, dac_bits=dac, adc_bits=adc)
    out = tref.crossbar_mvm_ref(t(v), t(gp), t(gn), **kw)
    _xbar_close(out, jref.crossbar_mvm_ref(*map(jnp.asarray, (v, gp, gn)),
                                           **kw), adc)


def test_crossbar_ref_bf16_matches_jax():
    """bf16 inputs: v widened before the DAC, gpos - gneg rounded to bf16
    before the widening, in both packages."""
    v, gp, gn = _xbar_inputs((), 128, 128, 128, seed=5)
    tin = [t(x, torch.bfloat16) for x in (v, gp, gn)]
    jin = [jnp.asarray(x, jnp.bfloat16) for x in (v, gp, gn)]
    out = tref.crossbar_mvm_ref(*tin, g0=G0)
    assert out.dtype == torch.float32
    scaled_close(out, jref.crossbar_mvm_ref(*jin, g0=G0), 1e-5)
    scaled_close(tref.crossbar_mvm_batched_ref(*(x[None] for x in tin),
                                               g0=G0)[0], out, 1e-6)


@pytest.mark.parametrize("l,b,r,c", [(1, 128, 128, 128), (4, 32, 64, 64),
                                     (3, 5, 70, 130)])
def test_crossbar_batched_ref_matches_vmapped_jax(l, b, r, c):
    v, gp, gn = _xbar_inputs((l,), b, r, c, seed=4)
    kw = dict(g0=G0, dac_bits=8, adc_bits=8)
    out = tref.crossbar_mvm_batched_ref(t(v), t(gp), t(gn), **kw)
    assert out.shape == (l, b, r)
    jin = [jnp.asarray(x) for x in (v, gp, gn)]
    want = jax.vmap(lambda vv, p, n: jref.crossbar_mvm_ref(vv, p, n, **kw))(
        *jin)
    _xbar_close(out, want, 8)
    _xbar_close(out, jops.crossbar_mvm_batched(*jin, interpret=True, **kw),
                8)
    for i in range(l):                    # the stack is L single arrays
        _xbar_close(out[i], tref.crossbar_mvm_ref(t(v[i]), t(gp[i]),
                                                  t(gn[i]), **kw), 8)


def test_crossbar_batched_on_a_flat_plan_inv_stack():
    """One INV bucket stack of a JAX-programmed flat plan (64x64 system,
    two stages of 16x16 arrays, sigma=0.05) through the port's batched
    entry point and the JAX Pallas kernel."""
    from repro.core import blockamc
    from repro.core.analog import AnalogConfig
    from repro.core.nonideal import NonidealConfig
    from repro.data.matrices import wishart
    cfg = AnalogConfig(array_size=16, nonideal=NonidealConfig(sigma=0.05))
    a = wishart(jax.random.PRNGKey(1), 64)
    fplan = blockamc.build_flat_plan(a, jax.random.PRNGKey(2), cfg, stages=2)
    grid = fplan.inv_stacks[0]
    num, s, _ = grid.shape
    v = np.random.default_rng(3).uniform(-1, 1, (num, 2, s)).astype(
        np.float32)
    out = tops.crossbar_mvm_batched(t(v), t(grid.gpos), t(grid.gneg),
                                    g0=cfg.g0)
    scaled_close(out, jops.crossbar_mvm_batched(
        jnp.asarray(v), grid.gpos, grid.gneg, g0=cfg.g0, interpret=True),
        1e-5)


def test_crossbar_cpu_wrappers_run_the_plain_version():
    v, gp, gn = (t(x) for x in _xbar_inputs((2,), 3, 5, 7))
    kw = dict(g0=G0, dac_bits=8, adc_bits=6)
    before = (txbar.crossbar_mvm.launches,
              txbar.crossbar_mvm_batched.launches)
    assert torch.equal(tops.crossbar_mvm(v[0], gp[0], gn[0], **kw),
                       tref.crossbar_mvm_ref(v[0], gp[0], gn[0], **kw))
    assert torch.equal(tops.crossbar_mvm_batched(v, gp, gn, **kw),
                       tref.crossbar_mvm_batched_ref(v, gp, gn, **kw))
    assert (txbar.crossbar_mvm.launches,
            txbar.crossbar_mvm_batched.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        txbar.crossbar_mvm_batched(v, gp, gn, g0=G0)


# ------------------------------- schur_gemm -------------------------------

@pytest.mark.parametrize("i,j,k", [(128, 128, 128), (256, 128, 384),
                                   (100, 60, 130)])
def test_schur_ref_matches_jax_oracle_and_pallas(i, j, k):
    rng = np.random.default_rng(i + j + k)
    a4, a3, w = (rng.normal(size=shape).astype(np.float32)
                 for shape in ((i, j), (i, k), (k, j)))
    out = tref.schur_update_ref(t(a4), t(a3), t(w))
    assert out.shape == (i, j) and out.dtype == torch.float32
    jin = [jnp.asarray(x) for x in (a4, a3, w)]
    scaled_close(out, jref.schur_update_ref(*jin), 1e-5)
    scaled_close(out, jops.schur_update(*jin, interpret=True), 1e-5)
    before = tschur.schur_update.launches
    assert torch.equal(tops.schur_update(t(a4), t(a3), t(w)), out)
    assert tschur.schur_update.launches == before


def test_schur_ref_bf16_widens_before_the_product():
    rng = np.random.default_rng(9)
    a4, a3, w = (rng.normal(size=(64, 64)).astype(np.float32)
                 for _ in range(3))
    out = tref.schur_update_ref(*(t(x, torch.bfloat16) for x in (a4, a3, w)))
    assert out.dtype == torch.float32
    scaled_close(out, jref.schur_update_ref(
        *(jnp.asarray(x, jnp.bfloat16) for x in (a4, a3, w))), 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        tschur.schur_update(t(a4), t(a3), t(w))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_crossbar_and_schur_entries_refuse_other_types(dtype):
    """The entries take float32 or bfloat16 on the host as on the card:
    another type raises instead of being rounded to float32 silently."""
    v = torch.zeros((2, 4, 8))
    g = torch.zeros((2, 3, 8))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tops.crossbar_mvm(v[0].to(dtype), g[0], g[0], g0=G0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tops.crossbar_mvm_batched(v, g.to(dtype), g, g0=G0)
    a = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tops.schur_update(a, a.to(dtype), a)


# ----------------------------- flash_attention -----------------------------

def _attn_inputs(bh, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bh, s, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("bh,s,d", [
    (2, 128, 128),     # single tile
    (1, 384, 128),     # 3x3 K blocks, causal skipping
    (2, 200, 128),     # ragged S
    (2, 200, 64),      # ragged S, the host-scale head dim
    (3, 64, 64),       # shorter than one JAX block
])
def test_flash_ref_and_wrapper_match_jax_oracle_and_pallas(bh, s, d):
    q, k, v = _attn_inputs(bh, s, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = jops.flash_attention(jq, jk, jv, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv)
    before = tflash.flash_attention.launches
    for got in (tref.flash_attention_ref(t(q), t(k), t(v)),
                tops.flash_attention(t(q), t(k), t(v))):
        for want in (pallas, oracle):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=2e-5, atol=2e-5)
    assert tflash.flash_attention.launches == before


def test_flash_non_causal_matches_jax():
    q, k, v = _attn_inputs(2, 128, 64, seed=1)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jops.flash_attention(jq, jk, jv, causal=False, interpret=True)
    for got in (tref.flash_attention_ref(t(q), t(k), t(v), causal=False),
                tops.flash_attention(t(q), t(k), t(v), causal=False)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(want), np.asarray(jref.flash_attention_ref(
            jq, jk, jv, causal=False)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 3e-2)])
def test_flash_dtypes_match_jax(dtype, tol):
    q, k, v = _attn_inputs(2, 256, 128, seed=2)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    # the same rounded inputs on both sides
    tq, tk, tv = (t(np.asarray(x, np.float32)).to(getattr(torch, dtype))
                  for x in (jq, jk, jv))
    want_kernel = jops.flash_attention(jq, jk, jv, interpret=True)
    want_oracle = jref.flash_attention_ref(jq, jk, jv)
    got_wrapper = tops.flash_attention(tq, tk, tv)
    got_ref = tref.flash_attention_ref(tq, tk, tv)
    assert got_wrapper.dtype == got_ref.dtype == getattr(torch, dtype)
    for got in (got_wrapper, got_ref):
        for want in (want_kernel, want_oracle):
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want, np.float32),
                rtol=tol, atol=tol)


def test_flash_entry_refuses_other_types_and_unaligned_full_attention():
    q = torch.zeros((1, 128, 64))
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            tops.flash_attention(q.to(dtype), q, q)
    with pytest.raises(ValueError, match="S % 128"):
        tops.flash_attention(q[:, :100], q[:, :100], q[:, :100],
                             causal=False)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, q, q)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_op_under_fake_tensors_builds_and_launches_nothing(
        monkeypatch, causal):
    """The attention kernel's op (`torch.ops.repro_torch.flash_attention`)
    on fake "cuda" tensors: its fake implementation gives the output's
    shape and dtype without building or launching the kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import _build

    def no_build(*args, **kwargs):
        raise AssertionError("the fake implementation built the kernel")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    before = tflash.flash_attention.launches
    with FakeTensorMode():
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.empty((6, 256, 128), dtype=dtype, device="cuda")
            out = tops.flash_attention(q, q, q, causal=causal)
            assert out.shape == q.shape and out.dtype == dtype
            assert out.device.type == "cuda"
    assert tflash.flash_attention.launches == before


@pytest.mark.parametrize("causal", [True, False])
def test_flash_op_flops_follow_the_registered_formula(causal):
    """`FlopCounterMode` counts 4 BH D FLOPs per live (row, key) pair of
    the op: S(S+1)/2 pairs causal, S^2 full (`chip_smoke._flash_bound`'s
    count)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    bh, s, d = 12, 384, 64
    pairs = s * (s + 1) // 2 if causal else s * s
    with FakeTensorMode():
        q = torch.empty((bh, s, d), dtype=torch.bfloat16, device="cuda")
        counter = FlopCounterMode(display=False)
        with counter:
            tops.flash_attention(q, q, q, causal=causal)
    assert counter.get_total_flops() == 4 * bh * d * pairs
    assert tops.flash_flops((bh, s, d), (bh, s, d), (bh, s, d), causal) \
        == 4 * bh * d * pairs


def test_bf16_rounding_rule_catches_a_fault_in_later_rows():
    """The card's bf16 attention check (`bf16_rounding_close`, also in
    chip_smoke.py phase 11): an exactly rounded output passes, and a 2%
    error in the later query tiles - whose outputs are ~1/sqrt(row) of the
    first rows' - fails, though it stays inside 1/128 of max|out|."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((4, 512, 128), generator=gen).bfloat16()
               for _ in range(3))
    want = tref.flash_attention_ref(q.float(), k.float(), v.float())
    rounded = want.bfloat16().float()
    bf16_rounding_close(rounded, want)
    faulty = rounded.clone()
    faulty[:, 256:] *= 1.02
    scaled_close(faulty, want, 1 / 128)
    with pytest.raises(AssertionError, match="bf16 limit"):
        bf16_rounding_close(faulty, want)


# ------------------ the tensor-core kernels' numerics, emulated ------------
# The CUDA kernels run on the card only; these tests emulate their rounding
# in plain torch on the host, at the sizes the card checks, to show why each
# kernel splits its operands.

def _tf32(x):
    """float32 rounded to TF32 as `cvt.rna.tf32.f32`: 10 mantissa bits,
    ties away from zero (on the bit pattern, so negatives alike)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_schur_needs_3xtf32_to_hold_the_float32_rule():
    """`csrc/schur_gemm.cu` in float32: one TF32 product lands ~3e-4 of
    max|out| from the float32 plain version at n=1024, over the kernel's
    1e-5; the 3xTF32 split (small.big + big.small + big.big, each product
    exact in float32) holds it."""
    rng = np.random.default_rng(1024)
    a4, a3, w = (t(rng.normal(size=(1024, 1024)).astype(np.float32))
                 for _ in range(3))
    want = tref.schur_update_ref(a4, a3, w)
    a_big, w_big = _tf32(a3), _tf32(w)
    a_small, w_small = _tf32(a3 - a_big), _tf32(w - w_big)
    three = a4 - a_small @ w_big - a_big @ w_small - a_big @ w_big
    scaled_close(three, want, 1e-5)
    with pytest.raises(AssertionError):
        scaled_close(a4 - a_big @ w_big, want, 1e-5)


def _tf32_product(a, b, three):
    """a @ b as the tensor cores compute it in float32: one TF32 product,
    or 3xTF32 (small.big + big.small + big.big, each product exact in
    float32), the sums in float32."""
    a_big, b_big = _tf32(a), _tf32(b)
    if not three:
        return a_big @ b_big
    return (_tf32(a - a_big) @ b_big + a_big @ _tf32(b - b_big)
            + a_big @ b_big)


@pytest.mark.parametrize("three", [False, True])
def test_f32_attention_needs_3xtf32_with_split_p(three):
    """`csrc/flash_attention.cu` in float32: with one TF32 product in Q K^T
    and in P V, full attention at (8, 1024, 128) lands ~7e-4 of max|out|
    from the float32 function, 70x the card's rule (1e-5 of max|out|);
    3xTF32 in both, p split in two TF32 parts too, holds it."""
    rng = np.random.default_rng(8)
    q, k, v = (t(rng.normal(size=(8, 1024, 128)).astype(np.float32))
               for _ in range(3))
    want = tref.flash_attention_ref(q, k, v, causal=False)
    s = _tf32_product(q, k.transpose(1, 2), three) * 128 ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    got = _tf32_product(p, v, three) / p.sum(-1, keepdim=True)
    if three:
        scaled_close(got, want, 1e-5)
    else:
        with pytest.raises(AssertionError):
            scaled_close(got, want, 1e-5)


@pytest.mark.parametrize("three", [False, True])
def test_block_thomas_needs_3xtf32_on_a_real_crossbar(three):
    """`csrc/banded_solve.cu` in float32: on a real 64 x 64 crossbar's
    factor stack (built as phase 6 of chip_smoke.py builds it), sweeps
    with one TF32 product land hundreds of times further from the float64
    sweeps than the plain float32 sweeps do; 3xTF32 stays within the
    card's limit, 4x the plain version's own error."""
    from repro_torch.physics import nodal
    rng = np.random.default_rng(64)
    g = t(rng.random((1, 64, 64)).astype(np.float32)) * 100e-6
    minvs, rhs, _ = nodal._mvm_prepare(g, torch.eye(64)[None], 1.0)
    truth = tref.block_tridiag_solve_ref(minvs.double(), rhs.double(),
                                         gw=1.0)

    def rel(x):
        return float((x.double() - truth).abs().max() / truth.abs().max())

    nr = rhs.shape[1]
    z, zs = torch.zeros_like(rhs[:, 0]), []
    for i in range(nr):
        z = _tf32_product(minvs[:, i], rhs[:, i] + z, three)
        zs.append(z)
    x, xs = torch.zeros_like(z), [None] * nr
    for i in reversed(range(nr)):
        x = zs[i] + _tf32_product(minvs[:, i], x, three)
        xs[i] = x
    err = rel(torch.stack(xs, 1))
    limit = 4 * rel(tref.block_tridiag_solve_ref(minvs, rhs, gw=1.0))
    assert (err <= limit) == three, (err, limit)


@pytest.mark.parametrize("bits", [8, 12, 13])
def test_crossbar_dac_codes_exact_in_tf32_up_to_12_bits(bits):
    """Every DAC code of a `bits`-wide converter survives tf32 rounding up
    to 12 bits; at 13 bits some do not (so the kernel runs 3xTF32 on the
    quantised values there)."""
    from repro_torch.core.quantization import quantizer_step
    step = np.float32(quantizer_step(bits, 1.0))
    v = np.linspace(-1, 1, 1 << 16, dtype=np.float32)
    q = t(np.rint(v / step).astype(np.float32))
    assert float(q.abs().max()) <= 2 ** (bits - 1)
    assert torch.equal(_tf32(q), q) == (bits <= txbar.CODE_BITS)


@pytest.mark.parametrize("two", [False, True])
def test_crossbar_needs_two_tf32_products_on_the_codes(two):
    """`csrc/crossbar_mvm.cu` with an 8-bit DAC at the bench's (B, R, C) =
    (512, 1024, 1024): the codes are exact in tf32, so G_hi.q + G_lo.q
    (each product exact in float32, float32 sums) holds the pre-ADC sums
    to 1e-5 of max|sum| against float64; one tf32 product, tf32(G).q,
    does not."""
    from repro_torch.core.quantization import quantizer_step
    rng = np.random.default_rng(512)
    v = rng.uniform(-1, 1, (512, 1024)).astype(np.float32)
    gp, gn = (rng.uniform(0, 100e-6, (1024, 1024)).astype(np.float32)
              for _ in range(2))
    q = t(np.rint(v / np.float32(quantizer_step(8, 1.0))))
    assert torch.equal(_tf32(q), q)
    g = t(gp - gn)
    truth = q.double() @ g.double().T
    g_hi = _tf32(g)
    got = q @ g_hi.T
    if two:
        got = q @ _tf32(g - g_hi).T + got
    assert (float((got.double() - truth).abs().max())
            <= 1e-5 * float(truth.abs().max())) == two


@pytest.mark.parametrize("bits", [8, 9, 10])
def test_crossbar_codes_take_three_bf16_products_up_to_9_bits(bits):
    """The crossbar's bound (`chip_smoke.py::_xbar_bound`) prices an 8-bit
    call at three bf16 products: DAC codes up to 9 bits (|q| <= 256) are
    exact in bf16 (10 bits are not), G = gpos - gneg is exactly the sum
    of three bf16 parts, and G_hi.q + G_mid.q + G_lo.q (each product exact
    in float32, float32 sums) holds the pre-ADC sums to 1e-5 of max|sum|
    against float64."""
    from repro_torch.core.quantization import quantizer_step
    rng = np.random.default_rng(bits)
    v = rng.uniform(-1, 1, (64, 256)).astype(np.float32)
    gp, gn = (rng.uniform(0, 100e-6, (256, 256)).astype(np.float32)
              for _ in range(2))
    q = t(np.rint(v / np.float32(quantizer_step(bits, 1.0))))
    exact = torch.equal(q.bfloat16().float(), q)
    assert exact == (bits <= 9)
    if not exact:
        return
    g = t(gp - gn)
    parts = []
    for _ in range(3):
        parts.append(g.sub(sum(parts, torch.zeros_like(g))).bfloat16()
                     .float())
    assert torch.equal(parts[0] + parts[1] + parts[2], g)
    got = sum(q @ part.T for part in reversed(parts))
    truth = q.double() @ g.double().T
    assert float((got.double() - truth).abs().max()) <= \
        1e-5 * float(truth.abs().max())


def _online_attention_bf16(q, k, v, split, bk=128):
    """The bf16 attention kernel's arithmetic on float32 copies of bf16
    (BH, S, D) inputs, causal: bk-key tiles, online softmax in float32, the
    p.v product on bf16 p - rounded once, or split into p_hi + p_lo - with
    float32 sums; the output rounded once to bf16."""
    bh, s, d = q.shape
    m = torch.full((bh, s, 1), -1e30)
    l = torch.zeros((bh, s, 1))
    acc = torch.zeros((bh, s, d))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, bk):
        kt, vt = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        sc = (q @ kt.transpose(1, 2)) * d ** -0.5
        cols = torch.arange(k0, k0 + kt.shape[1])[None, :]
        sc = sc.masked_fill(cols > rows, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        pv = p_hi @ vt
        if split:
            pv = pv + (p - p_hi).bfloat16().float() @ vt
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16().float()


def test_attention_needs_split_p_to_hold_the_bf16_rule():
    """`csrc/flash_attention.cu` in bf16: with p rounded once to bf16 for
    the tensor cores' p.v (as scaled_dot_product_attention does) outputs
    fall far outside the card's element-wise rule (2^-8 |ref| + 1e-5
    max|ref| against the float32 function); p = p_hi + p_lo, two bf16
    products into one float32 sum, holds it at (8, 1024, 128)."""
    rng = np.random.default_rng(8)
    q, k, v = (t(rng.normal(size=(8, 1024, 128)).astype(np.float32),
                 torch.bfloat16).float() for _ in range(3))
    want = tref.flash_attention_ref(q, k, v)
    bf16_rounding_close(_online_attention_bf16(q, k, v, split=True), want)
    with pytest.raises(AssertionError, match="bf16 limit"):
        bf16_rounding_close(_online_attention_bf16(q, k, v, split=False),
                            want)
