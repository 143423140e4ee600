"""GQA attention: causal for prefill and forward, KV-cache decode with
per-slot positions and sliding-window ring buffers, as
`repro/models/attention.py`.

The route of full-causal attention.  `attention`, `attention_prefill`
(and `transformer.block_forward`, `forward`, `block_prefill`, `prefill`)
take `use_flash`:

- None (the default): the flash route where it has the case - no
  sliding window, float32 or bfloat16 activations, no autograd recording
  through q, k or v and, for CUDA tensors, a head dim in
  `flash_attention.HEAD_DIMS` (64, 128) - else the q-chunked path
  `_chunked_attend`, which, as the reference's default, takes any head
  dim, dtype and batch.  The flash route is `kernels.ops.flash_attention`:
  the hand-written kernel for CUDA tensors (any batch x heads), its plain
  version, which takes any head dim, for CPU tensors.
- False: `_chunked_attend`.
- True: the flash route; raises where it lacks the case.

The kernel writes its output outside autograd, and the route is decided
alike on the card and on the host: whenever autograd records through q,
k or v (`torch.is_grad_enabled()` and one of them requires grad), the
default is `_chunked_attend`, which is differentiable and is the
reference's training route (its `loss_fn` never sets `use_flash`, and
its kernel is forward-only).  Under `torch.no_grad()` or
`torch.inference_mode()` - prefill, decode, serving - the default is the
kernel.  `use_flash=True` under grad recording raises, and so does the
kernel wrapper on the card for a tensor that requires grad.

This is the one place the port's default differs from the reference,
whose `forward` and `prefill` never set `use_flash` and so always take
the chunked path.  The port routes inference through the kernel on the
card because the kernel's own docstring names that its job on the
accelerator ("replaces the q-chunked jnp attention path ... for the
prefill cells"), and
`tests/test_kernels.py::test_flash_attention_in_model_layer` holds the
two routes equal (2e-4 in float32).  The flash route assumes
the positions are 0..S-1 (causal by index), as the reference's
`use_flash` route does; `forward` and `prefill` always pass those.

Rounding in bfloat16 differs between the routes, and that is not a bug:
`_chunked_attend` casts the softmax weights to bfloat16 before p . v (its
scores are bfloat16 products too), while the kernel keeps scores,
weights and sums in float32 and rounds once, at its output.  In float32
the two routes agree to reassociated rounding.

There is no fallback: on the card the kernel builds and launches, or the
call raises.  The projections stay `torch.matmul`, as the reference left
them to XLA.  The reference's `shard(...)` annotations are dropped (with
no sharding policy they are no-ops there too).

Decode writes the new key and value into the cache in place and returns
the same tensors: the serving loops own their caches (the reference's
continuous-batching step donates its cache for the same reason), and a
stacked cache updated through per-layer views needs no re-stacking.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import einsum, init_dense, mm, rope

NEG_INF = -2.0 ** 30


def _mask(scores: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """`scores` where `keep`, else NEG_INF in the scores' dtype (-inf in
    float16, whose range it passes), as the reference's `jnp.where`."""
    fill = torch.full((), NEG_INF, device=scores.device).to(scores.dtype)
    return torch.where(keep, scores, fill)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    """Draws wq, wk, wv, wo in that order."""
    hd = cfg.head_dim
    return {
        "wq": init_dense(gen, cfg.d_model, cfg.n_heads * hd, dtype),
        "wk": init_dense(gen, cfg.d_model, cfg.kv_heads * hd, dtype),
        "wv": init_dense(gen, cfg.d_model, cfg.kv_heads * hd, dtype),
        "wo": init_dense(gen, cfg.n_heads * hd, cfg.d_model, dtype),
    }


def _qkv(params: Dict, x: torch.Tensor, positions: torch.Tensor,
         cfg: ModelConfig
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = mm(x, params["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = mm(x, params["wk"]).reshape(b, s, cfg.kv_heads, hd)
    v = mm(x, params["wv"]).reshape(b, s, cfg.kv_heads, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _chunked_attend(q, k, v, positions, cfg: ModelConfig,
                    window: Optional[int], q_chunk: int) -> torch.Tensor:
    """Q-chunked causal attention core, flat-head layout.

    q: (B, S, H, hd); k, v: (B, S, KV, hd) - KV heads are repeated to H
    (query head h reads kv head h // q_per_kv).  Returns (B, S, H*hd).
    """
    b, s = q.shape[0], q.shape[1]
    hd = q.shape[-1]
    scale = hd ** -0.5
    if cfg.q_per_kv > 1:
        k = torch.repeat_interleave(k, cfg.q_per_kv, dim=2)   # (B, S, H, hd)
        v = torch.repeat_interleave(v, cfg.q_per_kv, dim=2)
    q_chunk = min(q_chunk, s)
    assert s % q_chunk == 0, (s, q_chunk)
    outs = []
    for c in range(s // q_chunk):
        q_i = q[:, c * q_chunk:(c + 1) * q_chunk]
        pos_i = positions[:, c * q_chunk:(c + 1) * q_chunk]
        scores = einsum("bqhd,bshd->bhqs", q_i, k) * scale
        mask = pos_i[:, None, :, None] >= positions[:, None, None, :]
        if window is not None:
            near = (pos_i[:, None, :, None]
                    - positions[:, None, None, :]) < window
            mask = torch.logical_and(mask, near)
        scores = _mask(scores, mask)
        w = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
        outs.append(einsum("bhqs,bshd->bqhd", w, v))
    return torch.cat(outs, dim=1).reshape(b, s, cfg.n_heads * hd)


def _flash_route(use_flash: Optional[bool], window: Optional[int],
                 head_dim: int, dtype: torch.dtype, on_card: bool,
                 grad: bool = False) -> bool:
    """Whether causal attention takes the flash route (see the module
    docstring) for activations of `dtype` and `head_dim`, on the card or
    on the host, with autograd recording through them (`grad`) or not."""
    missing = ("sliding window" if window is not None else
               f"{dtype} (only float32 or bfloat16)"
               if dtype not in kflash.DTYPES else
               f"head dim {head_dim} on the card (only {kflash.HEAD_DIMS})"
               if on_card and head_dim not in kflash.HEAD_DIMS else
               "gradient (it runs outside autograd)" if grad else None)
    if use_flash is None:
        return missing is None
    if use_flash and missing is not None:
        raise ValueError(f"use_flash=True: the flash kernel takes no "
                         f"{missing}")
    return bool(use_flash)


def _records_grad(*tensors) -> bool:
    """Whether autograd records through any of `tensors`."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def _flash_attend(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """The flash route: heads folded to (B*H, S, hd), KV heads repeated,
    one `ops.flash_attention` call.  Returns (B, S, H*hd)."""
    b, s = q.shape[0], q.shape[1]
    hd = cfg.head_dim
    g = cfg.q_per_kv
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)

    def fold(t):
        return t.transpose(1, 2).reshape(b * cfg.n_heads, s, hd)

    out = kops.flash_attention(fold(q), fold(k), fold(v), causal=True)
    out = out.reshape(b, cfg.n_heads, s, hd).transpose(1, 2)
    return out.reshape(b, s, cfg.n_heads * hd)


def attention(params: Dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, *, window: Optional[int] = None,
              q_chunk: int = 1024, use_flash: Optional[bool] = None
              ) -> torch.Tensor:
    """Causal (optionally sliding-window) self-attention.

    x: (B, S, d) -> (B, S, d).  positions: (B, S) absolute positions.
    `use_flash` picks the route (module docstring).
    """
    q, k, v = _qkv(params, x, positions, cfg)
    if _flash_route(use_flash, window, cfg.head_dim, q.dtype, q.is_cuda,
                    _records_grad(q, k, v)):
        out = _flash_attend(q, k, v, cfg)
    else:
        out = _chunked_attend(q, k, v, positions, cfg, window, q_chunk)
    return mm(out, params["wo"])


def attention_prefill(params: Dict, x: torch.Tensor,
                      positions: torch.Tensor, cfg: ModelConfig,
                      cache_len: int, *, window: Optional[int] = None,
                      q_chunk: int = 1024, cache_dtype=torch.bfloat16,
                      use_flash: Optional[bool] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """Full forward that also emits the KV cache for subsequent decode.

    Full-attention caches are laid out [0..S) with tail zeros; sliding-window
    caches are ring buffers (slot = pos % window) matching attention_decode.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, positions, cfg)
    if _flash_route(use_flash, window, cfg.head_dim, q.dtype, q.is_cuda,
                    _records_grad(q, k, v)):
        out = _flash_attend(q, k, v, cfg)
    else:
        out = _chunked_attend(q, k, v, positions, cfg, window, q_chunk)

    shape = (b, cache_len) + tuple(k.shape[2:])
    cache_k = torch.zeros(shape, dtype=cache_dtype, device=x.device)
    cache_v = torch.zeros_like(cache_k)
    if window is not None:
        w_eff = min(window, s)
        slots = torch.arange(s - w_eff, s, device=x.device) % cache_len
        cache_k[:, slots] = k[:, -w_eff:].to(cache_dtype)
        cache_v[:, slots] = v[:, -w_eff:].to(cache_dtype)
    else:
        cache_k[:, :s] = k.to(cache_dtype)
        cache_v[:, :s] = v.to(cache_dtype)
    return mm(out, params["wo"]), {"k": cache_k, "v": cache_v}


# ---------------------------------------------------------------------------
# Decode path (one new token against a KV cache)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, cache_len: int, cfg: ModelConfig,
                  dtype=torch.bfloat16, device="cuda") -> Dict:
    """Zeroed K/V caches on `device` (default the card; raises without
    one)."""
    device = resolve_device(device)
    hd = cfg.head_dim
    shape = (batch, cache_len, cfg.kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(params: Dict, x_t: torch.Tensor, cache: Dict,
                     pos, cfg: ModelConfig, *,
                     window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  x_t: (B, 1, d); pos: an int, a 0-d tensor OR (B,)
    positions.

    Per-slot positions let each sequence advance independently
    (continuous batching).  Full-attention caches hold the whole context;
    sliding-window caches are ring buffers of length `window`.  The new
    key and value are written into `cache` in place (module docstring);
    a slot past the cache's end is clamped to its last entry, as the
    reference's `dynamic_update_slice` clamps it.
    """
    b = x_t.shape[0]
    hd = cfg.head_dim
    cache_len = cache["k"].shape[1]
    if isinstance(pos, int):     # a fill on the device, not a host copy
        pos_b = torch.full((b,), pos, dtype=torch.int64, device=x_t.device)
    else:
        pos_b = torch.as_tensor(pos, device=x_t.device).long().expand(b)
    positions = pos_b[:, None]
    q, k_t, v_t = _qkv(params, x_t, positions, cfg)

    slot_b = pos_b % cache_len if window is not None else pos_b
    rows = torch.arange(b, device=x_t.device)
    at = slot_b.clamp(0, cache_len - 1)
    k, v = cache["k"], cache["v"]
    k[rows, at] = k_t[:, 0].to(k.dtype)
    v[rows, at] = v_t[:, 0].to(v.dtype)

    g = cfg.q_per_kv
    q = q.reshape(b, 1, cfg.kv_heads, g, hd)
    scores = einsum("bqkgd,bskd->bkgqs", q, k) * (hd ** -0.5)

    slot_ids = torch.arange(cache_len, device=x_t.device)[None, :]  # (1, S)
    if window is not None:
        # ring buffer: valid entries are the last min(pos+1, window) writes
        age = (slot_b[:, None] - slot_ids) % cache_len             # 0 = newest
        valid = age < torch.clamp(pos_b + 1, max=cache_len)[:, None]
    else:
        valid = slot_ids <= pos_b[:, None]
    scores = _mask(scores, valid[:, None, None, None, :])
    w = torch.softmax(scores.to(torch.float32), dim=-1).to(x_t.dtype)
    out = einsum("bkgqs,bskd->bqkgd", w, v).reshape(b, 1, cfg.n_heads * hd)
    return mm(out, params["wo"]), {"k": k, "v": v}
