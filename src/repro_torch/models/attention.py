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
  positions, and its output is wrapped back with q's placements.  Under
  the context-parallel rule q's sequence is also split as k's was
  split, so each rank attends its share of the queries (with their
  positions) to the whole keys, where a whole q would repeat the same
  attention on every rank of "model" (musicgen-medium's 24 heads and
  llama4-maverick's 40 on a 16-wide axis).  The kernel's causal mask
  needs the queries from position 0, so that split takes the chunked
  route, the reference's prefill route; only use_flash=True holds the
  kernel there, with q whole on every rank.  Projections whose features
  the heads do not split evenly are laid out with their features whole
  before the heads are split (`_heads`): under the context-parallel rule
  split by their sequence (an all-to-all, RoPE on each rank's rows), so
  that no rank holds q, k or v whole but the gathered keys and values,
  which the chunked route reads head-major (`_seq_gathered`); else
  gathered;
- outside autograd the sharded chunked route holds one float32 copy of
  a chunk's scores (`_weights_in_place`) and takes a query chunk whose
  live scores stay within SCORE_BYTES; the unsharded one keeps
  `torch.softmax`'s single pass, which one card's memory affords;
- prefill builds its cache on each rank's block of "act_cache", the
  layout decode keeps it in (`_cache_local`: no rank holds k, v or the
  cache whole); decode writes a DTensor cache in place shard by shard
  (`_put_local`: each rank writes the rows and slots it holds; DTensor
  refuses an in-place index write into a sharded tensor), and attends
  on local shards (`_decode_attend`), combining the softmax across the
  ranks that split the sequence as flash-decoding does, the ranks that
  hold the same rows and slots sharing out p . v's heads.

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
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import einsum, init_dense, mm, rope
from repro_torch.sharding.api import (box, ceil_share, current_policy,
                                      is_dtensor, lay_out, local_box,
                                      on_local, rank_among, replicated,
                                      rule_placements, seq_whole, shard,
                                      whole)

NEG_INF = -2.0 ** 30
# A chunk's live scores at most this many bytes on a sharded prefill
# (`_scores_chunk`): the scores in the activations' dtype and their one
# float32 copy together, which set the query chunk the chunked route
# takes there.
SCORE_BYTES = 1 << 29


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
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    return q, k, v


def _heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, n*hd) -> (B, S, n, hd).  A DTensor whose features are split
    over mesh dims that n heads do not divide is laid out with those
    features whole first, as DTensor splits no head: split by its
    sequence over them where the context-parallel rule ("act_kv") splits
    the keys' sequence there (an all-to-all: no rank holds the
    projection whole), else gathered."""
    b, s, f = t.shape
    if is_dtensor(t):
        mesh, place = t.device_mesh, t.placements
        split = [j for j, p in enumerate(place) if p.is_shard(2)]
        if n % math.prod(mesh.size(j) for j in split):
            cp = rule_placements("act_kv", (b, s, n, f // n))
            t = lay_out(t, mesh, [
                (Shard(1) if cp is not None and cp[j].is_shard(1)
                 else Replicate()) if p.is_shard(2) else p
                for j, p in enumerate(place)])
    return t.reshape(b, s, n, f // n)


def _rope(t: torch.Tensor, positions: torch.Tensor, theta: float
          ) -> torch.Tensor:
    """`rope` of t (B, S, H, hd); a DTensor whose sequence is split (the
    context-parallel projections, `_heads`) on each rank's own rows with
    their positions."""
    if not (is_dtensor(t) and any(p.is_shard(1) for p in t.placements)):
        return rope(t, positions, theta)
    size, off = local_box(t)
    pos = whole(positions)[off[0]:off[0] + size[0],
                           off[1]:off[1] + size[1]]
    return on_local(lambda u: rope(u, pos, theta), t, split=(0, 1, 2))


def _chunked_attend(q, k, v, positions, window: Optional[int],
                    q_chunk: int, q_positions=None,
                    one_copy: bool = False) -> torch.Tensor:
    """Q-chunked causal attention core, flat-head layout.

    q: (B, Sq, H, hd), k, v: (B, S, H, hd), KV heads already repeated to
    H; positions (B, S) are the keys', q_positions (B, Sq) the queries'
    (default: the keys').  Returns (B, Sq, H, hd).  With `one_copy`
    (the sharded route, whose peak a chip is held to the reference's)
    and outside autograd, a chunk's softmax holds one float32 copy of
    its scores (`_weights_in_place`); else `torch.softmax`'s one fused
    pass over the float32 cast, as under autograd.
    """
    if q_positions is None:
        q_positions = positions
    s = q.shape[1]
    scale = q.shape[-1] ** -0.5
    q_chunk = min(q_chunk, s)
    assert s % q_chunk == 0, (s, q_chunk)
    in_place = one_copy and not _records_grad(q, k, v)
    outs = []
    for c in range(s // q_chunk):
        q_i = q[:, c * q_chunk:(c + 1) * q_chunk]
        pos_i = q_positions[:, c * q_chunk:(c + 1) * q_chunk]
        mask = pos_i[:, None, :, None] >= positions[:, None, None, :]
        if window is not None:
            near = (pos_i[:, None, :, None]
                    - positions[:, None, None, :]) < window
            mask = torch.logical_and(mask, near)
        if in_place:            # the scores handed over, not held here
            w = _weights_in_place(einsum("bqhd,bshd->bhqs", q_i, k), scale,
                                  mask, q.dtype)
        else:
            scores = _mask(einsum("bqhd,bshd->bhqs", q_i, k) * scale, mask)
            w = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
            del scores          # not held into the next chunk's
        outs.append(einsum("bhqs,bshd->bqhd", w, v))
        del w
    return torch.cat(outs, dim=1)


def _weights_in_place(scores: torch.Tensor, scale: float,
                      keep: torch.Tensor, dtype) -> torch.Tensor:
    """The softmax weights of a chunk's raw scores (B, H, q, S), as the
    reference's: scaled and NEG_INF where not `keep` in their dtype (-inf
    in float16, whose range it passes, as `_mask`), then softmax in
    float32 along the keys - exp(x - max) / sum - and cast to `dtype`,
    with one float32 copy live: the scaling and the mask run in place on
    `scores`, the float32 copy is made by the shift (x - max, the cast in
    the same pass), and the rest runs in place on it.  Outside autograd
    only (`scores` is a temporary of the caller's)."""
    f32 = torch.float32
    scores.mul_(scale)
    fill = -math.inf if torch.finfo(scores.dtype).max < -NEG_INF \
        else NEG_INF
    scores.masked_fill_(torch.logical_not(keep), fill)
    top = scores.amax(dim=-1, keepdim=True).to(f32)
    e = scores.sub_(top) if scores.dtype == f32 else torch.sub(scores, top)
    del scores
    e.exp_()
    e.div_(e.sum(dim=-1, keepdim=True))
    return e.to(dtype)


def _scores_chunk(q_chunk: int, b: int, sq: int, h: int, sk: int,
                  itemsize: int) -> int:
    """The query chunk of a sharded prefill's chunked route, outside
    autograd: q_chunk (clipped to the sq local queries) halved while a
    chunk's live scores (b, h, chunk, sk) - in the activations' dtype of
    `itemsize` bytes beside their float32 copy (`_weights_in_place`; one
    buffer in float32) - exceed SCORE_BYTES and the half still divides
    sq.  Each query's softmax is its own, so the chunk changes what is
    live at once, not the result."""
    per = 4 + (itemsize if itemsize != 4 else 0)
    c = min(q_chunk, sq)
    while b * h * c * sk * per > SCORE_BYTES and c % 2 == 0 and c > 1:
        c //= 2
    return c


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


def _layout(q, k, v, cfg: ModelConfig, keep_flash: bool = False):
    """KV heads repeated to H (query head h reads kv head h // q_per_kv),
    then q, k, v laid out by the policy's "act_q" / "act_kv" rules - but
    a q whose sequence is already split where k's is (the
    context-parallel projections, `_heads`) keeps that split unless
    `keep_flash`: "act_q" would gather it whole only for `_attend` to
    split it again."""
    g = cfg.q_per_kv
    if g > 1:   # (B, S, H, hd).  A block of whole KV heads repeats to the
        # query heads that read it, so a DTensor's shards repeat alone
        k, v = (on_local(torch.repeat_interleave, t, g, 2, split=range(4))
                if is_dtensor(t) else torch.repeat_interleave(t, g, dim=2)
                for t in (k, v))
    k, v = shard(k, "act_kv"), shard(v, "act_kv")
    if keep_flash or not _seq_split_alike(q, k):
        q = shard(q, "act_q")
    return q, k, v


def _seq_split_alike(q, k) -> bool:
    """Whether DTensors q and k are both split by their sequence (dim 1)
    over a mesh dim of more than one rank."""
    return is_dtensor(q) and is_dtensor(k) and any(
        p.is_shard(1) and r.is_shard(1) and q.device_mesh.size(j) > 1
        for j, (p, r) in enumerate(zip(q.placements, k.placements)))


def _records_grad(*tensors) -> bool:
    """Whether autograd records through any of `tensors`."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def _attend(q, k, v, positions, cfg: ModelConfig, flash: bool,
            window: Optional[int] = None, q_chunk: int = 1024,
            keep_flash: bool = False) -> torch.Tensor:
    """Causal attention of q (B, S, H, hd) and k, v (B, S, KV, hd) by
    one route: `_flash_local` (one `ops.flash_attention` call) or
    `_chunked_attend`.  KV heads are repeated and q, k, v laid out first
    (`_layout`); DTensors are attended on each rank's local batch rows
    and heads, and under context parallelism on its share of the
    queries by the chunked route, unless `keep_flash` (use_flash=True)
    holds the kernel's route with q whole (module docstring).  Returns
    (B, S, H*hd)."""
    b, s = q.shape[0], q.shape[1]
    q, k, v = _layout(q, k, v, cfg, keep_flash)

    def core(q, k, v, positions, q_positions):
        if flash:
            return _flash_local(q, k, v)
        chunk, one_copy = q_chunk, False
        if q_positions is not None and not _records_grad(q, k, v):
            chunk = _scores_chunk(q_chunk, q.shape[0], q.shape[1],
                                  q.shape[2], k.shape[1], q.element_size())
            one_copy = True
        return _chunked_attend(q, k, v, positions, window, chunk,
                               q_positions, one_copy)

    if is_dtensor(q):           # batch rows and heads split, as q's
        mesh = q.device_mesh
        seq = [(p.is_shard(1) or p.is_replicate() and r.is_shard(1))
               and mesh.size(j) > 1
               for j, (p, r) in enumerate(zip(q.placements, k.placements))]
        if any(seq) and flash and keep_flash:
            seq = [False] * len(seq)    # the kernel's mask starts at query 0
        if any(seq):            # the queries split as k's sequence is
            flash = False
            q = lay_out(q, mesh, [Shard(1) if cut else p
                                  for p, cut in zip(q.placements, seq)])
        k, v = (_seq_gathered(t, [Replicate() if p.is_shard(1) else p
                                  for p in q.placements]) for t in (k, v))
        size, off = local_box(q)
        rows = whole(positions)[off[0]:off[0] + size[0]]
        out = on_local(core, q, k, v, rows,
                       rows[:, off[1]:off[1] + size[1]], split=(0, 1, 2))
    else:
        out = core(q, k, v, positions, None)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim)


def _seq_gathered(t: torch.Tensor, place) -> torch.Tensor:
    """The DTensor t (B, S, H, hd) laid out by `place`.  Where that
    gathers its sequence, it is gathered in the (B, H, S, hd) order and
    handed back as a (B, S, H, hd) view of that storage: the chunked
    route's products then read each head's keys and values in place,
    where a sequence-major t is copied head-major for every query
    chunk's product."""
    mesh = t.device_mesh
    if not any(p.is_shard(1) and not r.is_shard(1)
               for p, r in zip(t.placements, place)):
        return lay_out(t, mesh, place)

    def swap(pl):               # the placements with dims 1 and 2 swapped
        return [Shard({1: 2, 2: 1}.get(p.dim, p.dim)) if p.is_shard()
                else p for p in pl]
    t = on_local(lambda u: u.transpose(1, 2), t, split=range(4),
                 place=swap(t.placements))
    t = lay_out(t, mesh, swap(place))
    return on_local(lambda u: u.transpose(1, 2), t, split=range(4),
                    place=list(place))


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
    out = _attend(q, k, v, positions, cfg, flash, window, q_chunk,
                  keep_flash=use_flash is True)
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
    del x               # dead once projected: not held through attention
    flash = _flash_route(use_flash, window, cfg.head_dim, q.dtype,
                         q.is_cuda, _records_grad(q, k, v))
    out = _attend(q, k, v, positions, cfg, flash, window, q_chunk,
                  keep_flash=use_flash is True)
    del q

    target = rule_placements("act_cache", (b, cache_len) + tuple(k.shape[2:]))
    if target is None:
        k, v = whole(k), whole(v)
        shape = (b, cache_len) + tuple(k.shape[2:])
        cache_k = torch.zeros(shape, dtype=cache_dtype, device=k.device)
        cache_v = torch.zeros_like(cache_k)
        if window is not None:
            w_eff = min(window, s)
            slots = torch.arange(s - w_eff, s, device=k.device) % cache_len
            cache_k[:, slots] = k[:, -w_eff:].to(cache_dtype)
            cache_v[:, slots] = v[:, -w_eff:].to(cache_dtype)
        else:
            cache_k[:, :s] = k.to(cache_dtype)
            cache_v[:, :s] = v.to(cache_dtype)
    else:
        cache_k, cache_v = (_cache_local(t, cache_len, window, cache_dtype,
                                         target) for t in (k, v))
    cache = {"k": shard(cache_k, "act_cache"),
             "v": shard(cache_v, "act_cache")}
    return mm(out, params["wo"]), cache


def _cache_arcs(s: int, cache_len: int, window: Optional[int]):
    """The cache slots a prefill of s positions writes, as arcs
    (first slot, end slot, first position): [0, s) for a full cache; the
    ring slots pos % cache_len of the last min(window, s, cache_len)
    positions for a windowed one (where more positions than slots map
    to one slot, the last write is the one kept)."""
    if window is None:
        return [(0, s, 0)]
    m = min(window, s, cache_len)
    start = (s - m) % cache_len
    arcs = [(start, min(start + m, cache_len), s - m)]
    if start + m > cache_len:
        arcs.append((0, start + m - cache_len, s - m + cache_len - start))
    return arcs


def _cache_local(t: torch.Tensor, cache_len: int, window: Optional[int],
                 cache_dtype, target) -> torch.Tensor:
    """The (B, cache_len, KV, hd) cache of keys or values t (B, S, KV,
    hd), laid out by `target` ("act_cache"'s placements), built on each
    rank's own block: t is laid out with its batch as the cache's and
    its sequence whole (a split of its heads, or of its batch over a
    mesh dim that splits the cache's slots, stays), each rank fills the
    slots it will hold - or, where t's heads are split over the dim that
    splits the slots, its heads' share of every slot - from its local
    rows, and the block is laid out by `target` (an all-to-all of a
    rank's share where heads become slots).  No rank holds t or the
    cache whole."""
    mesh = current_policy().mesh
    if not is_dtensor(t):
        t = replicated(t, mesh)
    mid = []
    for p, q in zip(t.placements, target):
        if p.is_partial() or p.is_shard(1):
            mid.append(Replicate())
        elif q.is_shard(0):
            mid.append(q)
        else:
            mid.append(p)
    t = lay_out(t, mesh, mid)
    pre = [q if p.is_replicate() and q.is_shard(1) else p
           for p, q in zip(mid, target)]
    b, s = t.shape[0], t.shape[1]
    size, off = box((b, cache_len) + tuple(t.shape[2:]), mesh, pre)
    first, n = off[1], size[1]
    parts = []
    for c0, c1, p0 in _cache_arcs(s, cache_len, window):
        lo, hi = max(c0, first), min(c1, first + n)
        if lo < hi:
            parts.append((lo - first, hi - first, p0 + lo - c0))

    def build(tl):
        shape = (tl.shape[0], n) + tuple(tl.shape[2:])
        covered = sum(hi - lo for lo, hi, _ in parts) == n
        out = (tl.new_empty if covered else tl.new_zeros)(shape,
                                                          dtype=cache_dtype)
        for lo, hi, p in parts:
            out[:, lo:hi] = tl[:, p:p + hi - lo]
        return out
    return lay_out(on_local(build, t, split=range(t.dim()), place=pre),
                   mesh, target)


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
    # the ranks that hold the same rows and slots share out p . v's heads
    over = [j for j, p in enumerate(place)
            if p.is_replicate() and mesh.size(j) > 1]
    r, m = rank_among(mesh, over)
    heads = ceil_share(cfg.n_heads, r, m) if m > 1 else None
    out_place = [Shard(2) if j in over else p
                 for j, p in enumerate(rows_place)]

    def core(k, v, q):
        return _decode_core(q, k, v, whole(slot_b)[rows], whole(pos_b)[rows],
                            cfg, window, dtype, off[1], cache_len, groups,
                            heads)
    out = on_local(core, k, v, lay_out(q, mesh, rows_place), split=(0, 1),
                   place=out_place)
    if heads is None:
        return out
    out = lay_out(out, mesh, rows_place)
    return on_local(lambda t: t[..., :cfg.n_heads * cfg.head_dim], out,
                    split=(0,))


def _decode_core(q, k, v, slot_b, pos_b, cfg: ModelConfig,
                 window: Optional[int], dtype, first: int, cache_len: int,
                 groups, heads=None) -> torch.Tensor:
    """Decode attention of plain tensors: k, v hold cache slots
    [first, first + k.shape[1]) of `cache_len`; `groups` are the process
    groups the other slots lie over (none: the plain softmax).  With
    `heads` = (first head, end, width) the scores and their softmax are
    every head's, p . v its heads' alone: (B, 1, width * hd), the heads
    past `end` zero."""
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
    if not groups and heads is None:
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
    w = (e / total).to(dtype)
    if heads is None:
        out = einsum("bkgqs,bskd->bqkgd", w, v)
    else:                   # query head h reads kv head h // G
        h0, h1, width = heads
        w = w.reshape(b, cfg.n_heads, -1)[:, h0:h1]
        kv = torch.arange(h0, h1, device=v.device) // g
        out = einsum("bhs,bshd->bhd", w, v.index_select(2, kv))
    for group in groups:
        dist.all_reduce(out, group=group)
    if heads is None:
        return out.reshape(b, 1, cfg.n_heads * hd)
    out = out.reshape(b, 1, (h1 - h0) * hd)
    return F.pad(out, (0, (width - (h1 - h0)) * hd))


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
