"""Public kernel entry points, with the dtype policies of
`repro/kernels/ops.py`: the arena program computes in f32 and returns the
arena's dtype; the block-Thomas sweeps keep their input dtype, float64
included; the crossbar MVM and the Schur update take float32 or bfloat16
inputs and return float32; attention takes float32 or bfloat16 and
returns the inputs' dtype.

A tensor on the CPU runs the plain version (`ref.py`); a tensor on the
card launches the hand-written kernel, or raises - there is no fallback
for CUDA tensors.  The CUDA kernels mask their own edges (the rhs axis K,
the block size s, every axis of the crossbar and Schur products), so
nothing is padded to the TPU's 128 lanes; arena offsets and tile dims are
positions and are never padded either.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import arena_mvm as _arena
from repro_torch.kernels import banded_solve as _banded
from repro_torch.kernels import crossbar_mvm as _xbar
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import schur_gemm as _schur


def _refuse_grad(name, *tensors):
    """The kernels write their outputs outside autograd: a tensor that
    requires grad would get a result whose gradient is silently wrong, so
    it is refused."""
    if any(x.requires_grad for x in tensors):
        raise ValueError(
            f"{name} runs outside autograd: pass tensors that do not "
            f"require grad (detach them, or differentiate the caller's "
            f"plain path)")


def arena_packed_apply(arena, ops, in_offs, in_signs, out_offs, out_init, *,
                       dac_bits=None, adc_bits=None, fullscale: float = 1.0):
    """Run a whole packed tile program (see `kernels/arena_mvm.py`).

    arena (M, S, K), ops (M, T, R, C), window metadata (T, ...) shared by
    the instances.  Returns the updated arena in the arena's dtype.  On the
    card an f32 contiguous arena is updated in place (and returned); use
    the return value either way.  The kernel runs outside autograd, so an
    arena or ops that require grad are refused, on the host as on the card
    (`core.blockamc.execute_arena` differentiates the cascade itself).
    """
    _refuse_grad("arena_packed_apply", arena, ops)
    kw = dict(dac_bits=dac_bits, adc_bits=adc_bits, fullscale=fullscale)
    if arena.device.type == "cpu":
        out = _ref.arena_packed_ref(arena, ops, in_offs, in_signs, out_offs,
                                    out_init, **kw)
        return out.to(arena.dtype)
    if arena.device.type != "cuda":
        raise ValueError(f"no arena kernel for device {arena.device}")
    dev = arena.device
    out = arena.to(torch.float32).contiguous()
    _arena.arena_packed_apply(
        out, ops.to(torch.float32).contiguous(),
        in_offs.to(device=dev, dtype=torch.int32).contiguous(),
        in_signs.to(device=dev, dtype=torch.float32).contiguous(),
        out_offs.to(device=dev, dtype=torch.int32).contiguous(),
        out_init.to(device=dev, dtype=torch.int32).contiguous(), **kw)
    return out.to(arena.dtype)


def arena_level_apply(arena, ops, in_offs, in_signs, out_offs, out_init, *,
                      dac_bits=None, adc_bits=None, fullscale: float = 1.0):
    """One arena level group: arena (S, K), ops (L, R, C); the M=1 case of
    `arena_packed_apply`, through the same kernel."""
    return arena_packed_apply(arena[None], ops[None], in_offs, in_signs,
                              out_offs, out_init, dac_bits=dac_bits,
                              adc_bits=adc_bits, fullscale=fullscale)[0]


def block_tridiag_solve(minv, rhs, *, gw: float):
    """Batched block-Thomas sweeps over precomputed inverse factors (see
    `kernels/banded_solve.py`): minv (B, nr, s, s), rhs (B, nr, s, k) ->
    (B, nr, s, k) in the common dtype of the two, float32 or float64 (any
    other raises, on the host as on the card).  Tensors that require grad
    are refused, as `arena_packed_apply`'s are."""
    _refuse_grad("block_tridiag_solve", minv, rhs)
    dtype = torch.promote_types(minv.dtype, rhs.dtype)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"block-Thomas sweeps take float32 or float64, "
                         f"got {dtype}")
    if rhs.device.type == "cpu":
        return _ref.block_tridiag_solve_ref(minv.to(dtype), rhs.to(dtype),
                                            gw=gw)
    if rhs.device.type != "cuda":
        raise ValueError(f"no block-Thomas kernel for device {rhs.device}")
    return _banded.block_tridiag_solve(
        minv.to(device=rhs.device, dtype=dtype).contiguous(),
        rhs.to(dtype).contiguous(), gw=gw)


def _kernel_dtype(*tensors) -> torch.dtype:
    """bfloat16 if every tensor is bfloat16, else float32: the types the
    crossbar and Schur kernels take (bfloat16 widens to float32 exactly).
    Any other type raises, on the host as on the card."""
    for x in tensors:
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"the crossbar and Schur kernels take float32 "
                             f"or bfloat16, got {x.dtype}")
    if all(x.dtype == torch.bfloat16 for x in tensors):
        return torch.bfloat16
    return torch.float32


def _crossbar(name, launch, plain, v, gpos, gneg, **kw):
    """The crossbar entries' dispatch: the plain version for a CPU tensor,
    else the kernel on float32 / bfloat16 copies where needed."""
    vdt, gdt = _kernel_dtype(v), _kernel_dtype(gpos, gneg)
    if v.device.type == "cpu":
        return plain(v, gpos, gneg, **kw)
    _refuse_grad(name, v, gpos, gneg)
    if v.device.type != "cuda":
        raise ValueError(f"no crossbar kernel for device {v.device}")
    return launch(v.to(vdt).contiguous(),
                  gpos.to(device=v.device, dtype=gdt).contiguous(),
                  gneg.to(device=v.device, dtype=gdt).contiguous(), **kw)


def crossbar_mvm(v, gpos, gneg, *, g0: float, dac_bits=None,
                 adc_bits=None, fullscale: float = 1.0):
    """Differential crossbar MVM (see `kernels/crossbar_mvm.py`):
    v (B, C), gpos/gneg (R, C) -> (B, R) float32, any shapes; float32 or
    bfloat16 in (any other type raises).  On the card, tensors that
    require grad are refused (the kernel runs outside autograd); the plain
    version on the host is differentiable."""
    return _crossbar("crossbar_mvm", _xbar.crossbar_mvm,
                     _ref.crossbar_mvm_ref, v, gpos, gneg, g0=g0,
                     dac_bits=dac_bits, adc_bits=adc_bits,
                     fullscale=fullscale)


def crossbar_mvm_batched(v, gpos, gneg, *, g0: float, dac_bits=None,
                         adc_bits=None, fullscale: float = 1.0):
    """The crossbar MVM over a stack of L physical arrays, one launch:
    v (L, B, C), gpos/gneg (L, R, C) -> (L, B, R) float32."""
    return _crossbar("crossbar_mvm_batched", _xbar.crossbar_mvm_batched,
                     _ref.crossbar_mvm_batched_ref, v, gpos, gneg, g0=g0,
                     dac_bits=dac_bits, adc_bits=adc_bits,
                     fullscale=fullscale)


def schur_update(a4, a3, w):
    """Fused A4 - A3 @ W (see `kernels/schur_gemm.py`): a4 (I, J),
    a3 (I, K), w (K, J) -> (I, J) float32, any shapes; float32 or
    bfloat16 in (any other type raises).  On the card, tensors that
    require grad are refused, as the crossbar's are."""
    dtype, dev = _kernel_dtype(a4, a3, w), a4.device
    if dev.type == "cpu":
        return _ref.schur_update_ref(a4, a3, w)
    _refuse_grad("schur_update", a4, a3, w)
    if dev.type != "cuda":
        raise ValueError(f"no Schur kernel for device {dev}")
    return _schur.schur_update(
        *(x.to(device=dev, dtype=dtype).contiguous() for x in (a4, a3, w)))


def flash_attention(q, k, v, *, causal: bool = True):
    """Blocked causal (or full) attention (see
    `kernels/flash_attention.py`): q, k, v (BH, S, D) -> (BH, S, D) in q's
    dtype, float32 or bfloat16 (any other type raises, on the host as on
    the card).  A non-causal call needs S % 128 == 0, as the JAX wrapper's.

    On the CPU this is the kernel's function evaluated by the plain
    version on float32 copies, cast back to q's dtype (any D).  Any other
    tensor goes through the op `torch.ops.repro_torch.flash_attention`:
    on the card the kernel, which takes D in (64, 128) and raises on any
    other, and refuses tensors that require grad (`models/attention.py`
    routes a differentiated attention to its chunked path); under a
    `FakeTensorMode` the op's fake implementation, which gives the
    output's shape and dtype with no build and no launch, so that the dry
    run (`launch/dryrun.py`) traces the default route and counts its FLOPs
    with the formula registered here.
    """
    for x in (q, k, v):
        if x.dtype not in _flash.DTYPES:
            raise ValueError(f"attention takes float32 or bfloat16, got "
                             f"{x.dtype}")
    if not causal and q.shape[1] % 128:
        raise ValueError("non-causal flash requires S % 128 == 0")
    if q.device.type == "cpu":
        f32 = torch.float32
        return _ref.flash_attention_ref(q.to(f32), k.to(f32), v.to(f32),
                                        causal=causal).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return torch.ops.repro_torch.flash_attention(q, k, v, causal)


# The attention kernel as an operator of the "repro_torch" namespace: a
# CUDA implementation (the launch), a fake one (the output's shape and
# dtype, for tensors under a FakeTensorMode) and a FLOP formula.
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal) "
            "-> Tensor")


def _flash_cuda(q, k, v, causal):
    _refuse_grad("flash_attention", q, k, v)

    def ready(x):       # one dtype, contiguous, 16-byte aligned
        x = x.to(device=q.device, dtype=q.dtype).contiguous()
        return x if x.data_ptr() % 16 == 0 else x.clone()

    return _flash.flash_attention(ready(q), ready(k), ready(v),
                                  causal=causal)


def _flash_fake(q, k, v, causal):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


_LIB.impl("flash_attention", _flash_cuda, "CUDA")
torch.library.register_fake("repro_torch::flash_attention", _flash_fake,
                            lib=_LIB)


def flash_flops(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    """FLOPs of one attention call: 4*BH*D per live (row, key) pair,
    S(S+1)/2 of them causal and S^2 full (the two products q.k^T and p.v,
    two FLOPs a multiply-add each)."""
    bh, s, d = q_shape
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * bh * d * pairs


register_flop_formula(torch.ops.repro_torch.flash_attention)(flash_flops)
