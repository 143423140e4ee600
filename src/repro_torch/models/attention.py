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
them to XLA.

The reference's `shard(...)` annotations stand where it has them: q on
"act_q", the head-repeated k and v on "act_kv", and decode's updated
cache on "act_cache"; both routes lay q, k and v out first.  With no
policy they are the identity.  Under a policy (`sharding/api.py`) they
are DTensors, and the attention cores run on each rank's local shards -
DTensor's own rules for the cores' einsums and views differ between
torch releases, and the local form is what a sharded kernel needs:

- both routes (`_attend`): k and v are laid out as q is, with the
  sequence whole (under the context-parallel rule, where k and v split
  the sequence, that gathers them along "model": a core over a share of
  the keys would be silently wrong), the core - the kernel or
  `_chunked_attend` - takes the local tensors with the local rows'
  positions, and its output is wrapped back with q's placements.  On the
  chunked route the context-parallel rule also splits q's sequence as
  k's was split, so each rank attends its share of the queries (with
  their positions) to the whole keys, where a whole q would repeat the
  same attention on every rank of "model"; the kernel's causal mask
  needs the queries from position 0, so its route keeps q whole.
  Projections whose features the heads do not split evenly are gathered
  before the heads are split (`_heads`);
- prefill lays its cache out by "act_cache", the layout decode keeps it
  in; decode writes a DTensor cache in place shard by shard
  (`_put_local`: each rank writes the rows and slots it holds; DTensor
  refuses an in-place index write into a sharded tensor), and attends
  on local shards (`_decode_attend`), combining the softmax across the
  ranks that split the sequence as flash-decoding does.

Masks, positions and constants stay plain tensors, which the policy's
scope treats as replicated.

Decode writes the new key and value into the cache in place and returns
the same tensors: the serving loops own their caches (the reference's
continuous-batching step donates its cache for the same reason), and a
stacked cache updated through per-layer views needs no re-stacking.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import einsum, init_dense, mm, rope
from repro_torch.sharding.api import (is_dtensor, lay_out, local_box,
                                      on_local, seq_whole, shard, whole)

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
    x = seq_whole(x)            # one gather of a split sequence, not three
    q = _heads(mm(x, params["wq"]), cfg.n_heads)
    k = _heads(mm(x, params["wk"]), cfg.kv_heads)
    v = _heads(mm(x, params["wv"]), cfg.kv_heads)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, n*hd) -> (B, S, n, hd).  A DTensor whose features are split
    over mesh dims that n heads do not divide (the context-parallel case)
    is gathered along them first, as DTensor splits no head."""
    b, s, f = t.shape
    if is_dtensor(t):
        mesh, place = t.device_mesh, t.placements
        split = [j for j, p in enumerate(place) if p.is_shard(2)]
        if n % math.prod(mesh.size(j) for j in split):
            t = lay_out(t, mesh, [Replicate() if p.is_shard(2) else p
                                  for p in place])
    return t.reshape(b, s, n, f // n)


def _chunked_attend(q, k, v, positions, window: Optional[int],
                    q_chunk: int, q_positions=None) -> torch.Tensor:
    """Q-chunked causal attention core, flat-head layout.

    q: (B, Sq, H, hd), k, v: (B, S, H, hd), KV heads already repeated to
    H; positions (B, S) are the keys', q_positions (B, Sq) the queries'
    (default: the keys').  Returns (B, Sq, H, hd).
    """
    if q_positions is None:
        q_positions = positions
    s = q.shape[1]
    scale = q.shape[-1] ** -0.5
    q_chunk = min(q_chunk, s)
    assert s % q_chunk == 0, (s, q_chunk)
    outs = []
    for c in range(s // q_chunk):
        q_i = q[:, c * q_chunk:(c + 1) * q_chunk]
        pos_i = q_positions[:, c * q_chunk:(c + 1) * q_chunk]
        scores = einsum("bqhd,bshd->bhqs", q_i, k) * scale
        mask = pos_i[:, None, :, None] >= positions[:, None, None, :]
        if window is not None:
            near = (pos_i[:, None, :, None]
                    - positions[:, None, None, :]) < window
            mask = torch.logical_and(mask, near)
        scores = _mask(scores, mask)
        w = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
        outs.append(einsum("bhqs,bshd->bqhd", w, v))
    return torch.cat(outs, dim=1)


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


def _layout(q, k, v, cfg: ModelConfig):
    """KV heads repeated to H (query head h reads kv head h // q_per_kv),
    then q, k, v laid out by the policy's "act_q" / "act_kv" rules."""
    if cfg.q_per_kv > 1:
        k = torch.repeat_interleave(k, cfg.q_per_kv, dim=2)   # (B, S, H, hd)
        v = torch.repeat_interleave(v, cfg.q_per_kv, dim=2)
    return shard(q, "act_q"), shard(k, "act_kv"), shard(v, "act_kv")


def _records_grad(*tensors) -> bool:
    """Whether autograd records through any of `tensors`."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def _attend(q, k, v, positions, cfg: ModelConfig, flash: bool,
            window: Optional[int] = None, q_chunk: int = 1024
            ) -> torch.Tensor:
    """Causal attention of q (B, S, H, hd) and k, v (B, S, KV, hd) by
    one route: `_flash_local` (one `ops.flash_attention` call) or
    `_chunked_attend`.  KV heads are repeated and q, k, v laid out first
    (`_layout`); DTensors are attended on each rank's local batch rows
    and heads, and on the chunked route under context parallelism on its
    share of the queries (module docstring).  Returns (B, S, H*hd)."""
    b, s = q.shape[0], q.shape[1]
    q, k, v = _layout(q, k, v, cfg)

    def core(q, k, v, positions, q_positions):
        if flash:
            return _flash_local(q, k, v)
        return _chunked_attend(q, k, v, positions, window, q_chunk,
                               q_positions)

    if is_dtensor(q):           # batch rows and heads split, as q's
        mesh = q.device_mesh
        if not flash:           # the queries split as k's sequence is
            q = lay_out(q, mesh, [
                Shard(1) if p.is_replicate() and r.is_shard(1) else p
                for p, r in zip(q.placements, k.placements)])
        k, v = (lay_out(t, mesh, [Replicate() if p.is_shard(1) else p
                                  for p in q.placements]) for t in (k, v))
        size, off = local_box(q)
        rows = whole(positions)[off[0]:off[0] + size[0]]
        out = on_local(core, q, k, v, rows,
                       rows[:, off[1]:off[1] + size[1]], split=(0, 1, 2))
    else:
        out = core(q, k, v, positions, None)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim)


def _flash_local(q, k, v) -> torch.Tensor:
    """Causal attention of (B, S, H, hd) tensors through one kernel
    call, heads folded to (B*H, S, hd); returns (B, S, H, hd)."""
    b, s, h, hd = q.shape

    def fold(t):
        return t.transpose(1, 2).reshape(b * h, s, hd)

    out = kops.flash_attention(fold(q), fold(k), fold(v), causal=True)
    return out.reshape(b, h, s, hd).transpose(1, 2).contiguous()


def attention(params: Dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, *, window: Optional[int] = None,
              q_chunk: int = 1024, use_flash: Optional[bool] = None
              ) -> torch.Tensor:
    """Causal (optionally sliding-window) self-attention.

    x: (B, S, d) -> (B, S, d).  positions: (B, S) absolute positions.
    `use_flash` picks the route (module docstring).
    """
    q, k, v = _qkv(params, x, positions, cfg)
    flash = _flash_route(use_flash, window, cfg.head_dim, q.dtype,
                         q.is_cuda, _records_grad(q, k, v))
    out = _attend(q, k, v, positions, cfg, flash, window, q_chunk)
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
    flash = _flash_route(use_flash, window, cfg.head_dim, q.dtype,
                         q.is_cuda, _records_grad(q, k, v))
    out = _attend(q, k, v, positions, cfg, flash, window, q_chunk)

    k, v = whole(k), whole(v)
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
    cache = {"k": shard(cache_k, "act_cache"),
             "v": shard(cache_v, "act_cache")}
    return mm(out, params["wo"]), cache


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
    at = slot_b.clamp(0, cache_len - 1)
    k, v = cache["k"], cache["v"]
    if is_dtensor(k):
        _put_local(k, at, k_t[:, 0])
        _put_local(v, at, v_t[:, 0])
    else:
        rows = torch.arange(b, device=x_t.device)
        k[rows, at] = whole(k_t[:, 0]).to(k.dtype)
        v[rows, at] = whole(v_t[:, 0]).to(v.dtype)

    out = _decode_attend(q, shard(k, "act_cache"), shard(v, "act_cache"),
                         slot_b, pos_b, cfg, window, x_t.dtype)
    return mm(out, params["wo"]), {"k": k, "v": v}


def _decode_attend(q, k, v, slot_b, pos_b, cfg: ModelConfig,
                   window: Optional[int], dtype) -> torch.Tensor:
    """One query a row against the caches k, v (B, S, KV, hd); returns
    (B, 1, H*hd).  DTensor caches (split along batch and sequence only)
    are attended on local shards: q joins the cache's batch split, each
    rank scores its own slots, and where the sequence is split over
    ranks the softmax's max and sum and the p . v products are summed
    across them (flash-decoding's combine); on a single rank of the
    sequence the local softmax is the plain one.  The weights are cast
    to `dtype` (the activations') before p . v."""
    if not is_dtensor(k):
        return _decode_core(q, k, v, slot_b, pos_b, cfg, window, dtype, 0,
                            k.shape[1], ())
    mesh, place = k.device_mesh, k.placements
    rows_place = [p if p.is_shard(0) else Replicate() for p in place]
    size, off = local_box(k)
    rows = slice(off[0], off[0] + size[0])
    groups = tuple(mesh.get_group(j) for j, p in enumerate(place)
                   if p.is_shard(1) and mesh.size(j) > 1)
    cache_len = k.shape[1]

    def core(k, v, q):
        return _decode_core(q, k, v, whole(slot_b)[rows], whole(pos_b)[rows],
                            cfg, window, dtype, off[1], cache_len, groups)
    return on_local(core, k, v, lay_out(q, mesh, rows_place), split=(0, 1),
                    place=rows_place)


def _decode_core(q, k, v, slot_b, pos_b, cfg: ModelConfig,
                 window: Optional[int], dtype, first: int, cache_len: int,
                 groups) -> torch.Tensor:
    """Decode attention of plain tensors: k, v hold cache slots
    [first, first + k.shape[1]) of `cache_len`; `groups` are the process
    groups the other slots lie over (none: the plain softmax)."""
    b, hd, g = q.shape[0], cfg.head_dim, cfg.q_per_kv
    q = q.reshape(b, 1, cfg.kv_heads, g, hd)
    scores = einsum("bqkgd,bskd->bkgqs", q, k) * (hd ** -0.5)

    slot_ids = torch.arange(k.shape[1], device=q.device)[None, :]
    if first:
        slot_ids = slot_ids + first
    if window is not None:
        # ring buffer: valid entries are the last min(pos+1, window) writes
        age = (slot_b[:, None] - slot_ids) % cache_len             # 0 = newest
        valid = age < torch.clamp(pos_b + 1, max=cache_len)[:, None]
    else:
        valid = slot_ids <= pos_b[:, None]
    scores = _mask(scores, valid[:, None, None, None, :])
    if not groups:
        w = torch.softmax(scores.to(torch.float32), dim=-1).to(dtype)
        return einsum("bkgqs,bskd->bqkgd", w, v).reshape(
            b, 1, cfg.n_heads * hd)
    s32 = scores.to(torch.float32)
    top = s32.amax(dim=-1, keepdim=True)
    for group in groups:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(s32 - top)
    total = e.sum(dim=-1, keepdim=True)
    for group in groups:
        dist.all_reduce(total, group=group)
    out = einsum("bkgqs,bskd->bqkgd", (e / total).to(dtype), v)
    for group in groups:
        dist.all_reduce(out, group=group)
    return out.reshape(b, 1, cfg.n_heads * hd)


def _put_local(c: torch.Tensor, at: torch.Tensor, val: torch.Tensor
               ) -> None:
    """c[b, at[b]] = val[b] for every batch row b, in place, for a
    DTensor cache: DTensor refuses an in-place index write into a
    sharded tensor, so each rank writes, in its local shard, the rows it
    holds where the slot is one it holds (no host read, no communication
    but gathering `val` whole)."""
    local = c.to_local()
    size, off = local_box(c)
    val, at = whole(val), whole(at)
    rows = slice(off[0], off[0] + size[0])
    tail = tuple(slice(o, o + n) for o, n in zip(off[2:], size[2:]))
    slot = at[rows] - off[1]
    hit = (slot >= 0) & (slot < size[1])
    idx = slot.clamp(0, max(size[1] - 1, 0))
    local_rows = torch.arange(size[0], device=local.device)
    new = val[rows][(slice(None),) + tail].to(local.dtype)
    keep = local[local_rows, idx]
    local[local_rows, idx] = torch.where(
        hit.reshape((-1,) + (1,) * (new.dim() - 1)), new, keep)
