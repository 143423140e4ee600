"""Decoder-only transformer assembly, as `repro/models/transformer.py`,
for every block kind of the reference: attention (`attn`), RG-LRU
(`rec`, `models/rglru.py`) and SSD (`ssm`, `models/ssm.py`) mixers, each
followed, where the config has an FFN, by a dense SwiGLU or an MoE FFN
(`models/moe.py`, whose auxiliary loss `forward` sums over the layers).

The layer stack is the reference's: a repeated `layer_pattern` unit whose
homogeneous repeats are stacked on a leading axis under `params["blocks"]`
(and `cache["blocks"]`), and the pattern's remainder layers unrolled as
`rem{r}`, so that `interop.lm_params_from_numpy` maps one onto the other
key for key.  The reference scans over the stacked axis; the port runs a
Python loop over it, over views of the stacked tensors (`forward` takes
them with one `unbind` a tensor, whose backward is one `stack`).
In hybrid patterns (a `rec` block in the unit) the attention blocks run
over the config's `local_window` (`forward`'s `window_override` replaces
it): their prefill caches and `init_cache`'s are ring buffers of
min(cache_len, local_window) slots, and the windowed attention takes the
chunked path (`models/attention.py`).

`init_params(gen, cfg)` cannot replay `jax.random`; it draws from one
`torch.Generator`, on the generator's device, in this order: the
embedding, the LM head (untied configs), then every stacked repeat in
order and each block of its unit in order, then the remainder layers; a
block draws its mixer (attention: wq, wk, wv, wo; RG-LRU and SSM in their
modules' orders), then its FFN (dense: gate, up, down; MoE in its
module's order).  Norm weights are zeros.

`use_flash` on `block_forward`, `forward`, `block_prefill` and `prefill`
routes full-causal attention (see `models/attention.py`): by default
through the hand-written flash kernel for CUDA tensors, and through the
chunked path wherever autograd records.  Decode updates the cache in
place and returns it, the recurrent states included.

`remat` ("none" | "dots" | "full") rematerialises each repeat of the
stacked unit in `forward`, as the reference's `jax.checkpoint` of its
scan body (the remainder layers are not rematerialised there either),
with `torch.utils.checkpoint` (`use_reentrant=False`).  "full" saves
nothing but the repeat's inputs; "dots" is the reference's
`checkpoint_dots_with_no_batch_dims`: the outputs of the projections'
matmuls (`aten.mm`, `aten.addmm`) are saved and everything else,
the attention's batched score products (`aten.bmm`) included, is
recomputed in the backward.  Remat changes memory, never values.

While a profiler records, the embedding (`lm.embed`), an attention
block's attention with its first norm (`lm.attn`), each block's FFN with
its norm and residual add (`lm.ffn`) and the head (`lm.head`) are spans
of `repro_torch.tracing`.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils import checkpoint as ckpt

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (mm, rms_norm, softcap, swiglu_ffn,
                                       swiglu_ffn_init)
from repro_torch.sharding.api import (is_dtensor, lay_out, local_box,
                                      on_local, shard)
from repro_torch.tree import tree_map


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // 256) * 256


def _dtype(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _index(tree, r: int):
    """Repeat r of a stacked tree: views, no copies."""
    return tree_map(lambda x: x[r], tree)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

_INIT_MIX = {"attn": attn_mod.init_attention, "rec": rglru_mod.init_rglru,
             "ssm": ssm_mod.init_ssm}


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               is_moe: bool) -> Dict:
    dtype = _dtype(cfg.param_dtype)
    if kind not in _INIT_MIX:
        raise ValueError(kind)
    params: Dict[str, Any] = {
        "ln1": torch.zeros((cfg.d_model,), dtype=torch.float32,
                           device=gen.device),
        "mix": _INIT_MIX[kind](gen, cfg, dtype),
    }
    if cfg.d_ff > 0:
        params["ln2"] = torch.zeros((cfg.d_model,), dtype=torch.float32,
                                    device=gen.device)
        params["ffn"] = (moe_mod.init_moe(gen, cfg, dtype) if is_moe else
                         swiglu_ffn_init(gen, cfg.d_model, cfg.d_ff, dtype))
    return params


def _ffn(params: Dict, x: torch.Tensor, cfg: ModelConfig, is_moe: bool
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's FFN with its residual, where the config has one:
    (x, the MoE aux loss, zero for a dense FFN or none)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.d_ff == 0:
        return x, aux
    # the norm's output is handed on, not held here, and the FFN's
    # output laid out before the residual's add: neither the norm's
    # output nor a partial sum's storage is live at the add
    with tracing.span("lm.ffn"):
        if is_moe:
            out, aux = moe_mod.moe_ffn(
                params["ffn"], rms_norm(x, params["ln2"], cfg.norm_eps),
                cfg)
        else:
            out = swiglu_ffn(params["ffn"],
                             rms_norm(x, params["ln2"], cfg.norm_eps))
        out = shard(out, "act_btd")
        return x + out, aux


def _window(cfg: ModelConfig, unit) -> Optional[int]:
    """The attention window of a pattern: `local_window` in hybrid
    patterns (a `rec` block in the unit), else none."""
    return cfg.local_window if any(k == "rec" for k, _ in unit) else None


def block_forward(params: Dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, kind: str, is_moe: bool,
                  window: Optional[int], *, use_flash: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block.  Returns (x, aux_loss)."""
    norm = functools.partial(rms_norm, x, params["ln1"], cfg.norm_eps)
    if kind == "attn":
        with tracing.span("lm.attn"):
            mixed = attn_mod.attention(params["mix"], norm(), positions, cfg,
                                       window=window, use_flash=use_flash)
    elif kind == "rec":
        mixed = rglru_mod.rglru_forward(params["mix"], norm(), cfg)
    else:
        mixed = ssm_mod.ssm_forward(params["mix"], norm(), cfg)
    x, aux = _ffn(params, shard(x + shard(mixed, "act_btd"), "act_btd"),
                  cfg, is_moe)
    return shard(x, "act_btd"), aux


def init_block_cache(batch: int, cache_len: int, cfg: ModelConfig,
                     kind: str, dtype=torch.bfloat16, device="cuda") -> Dict:
    if kind == "attn":
        return attn_mod.init_kv_cache(batch, cache_len, cfg, dtype, device)
    if kind == "rec":
        return rglru_mod.init_rglru_cache(batch, cfg, dtype, device)
    return ssm_mod.init_ssm_cache(batch, cfg, dtype, device)


def block_decode(params: Dict, x_t: torch.Tensor, cache: Dict, pos,
                 cfg: ModelConfig, kind: str, is_moe: bool,
                 window: Optional[int]) -> Tuple[torch.Tensor, Dict]:
    h = rms_norm(x_t, params["ln1"], cfg.norm_eps)
    if kind == "attn":
        mixed, cache = attn_mod.attention_decode(params["mix"], h, cache,
                                                 pos, cfg, window=window)
    elif kind == "rec":
        mixed, cache = rglru_mod.rglru_decode(params["mix"], h, cache, cfg)
    else:
        mixed, cache = ssm_mod.ssm_decode(params["mix"], h, cache, cfg)
    x_t, _ = _ffn(params, x_t + mixed, cfg, is_moe)
    return x_t, cache


# ---------------------------------------------------------------------------
# Stack layout: stacked super-layers + unrolled remainder
# ---------------------------------------------------------------------------

def _pattern(cfg: ModelConfig) -> Tuple[Tuple[str, bool], ...]:
    """The repeating unit as ((kind, is_moe), ...)."""
    if cfg.layer_pattern:
        kinds = cfg.layer_pattern
    elif cfg.family == "ssm":
        kinds = ("ssm",)
    else:
        kinds = ("attn",)
    period = max(len(kinds), cfg.moe_every if cfg.n_experts else 1)
    # extend kinds cyclically to the common period
    unit = []
    for i in range(period):
        unit.append((kinds[i % len(kinds)], cfg.is_moe_layer(i)))
    return tuple(unit)


def stack_layout(cfg: ModelConfig
                 ) -> Tuple[Tuple[Tuple[str, bool], ...], int, int]:
    """(pattern unit, n_stacked_repeats, n_remainder_layers)."""
    unit = _pattern(cfg)
    p = len(unit)
    return unit, cfg.n_layers // p, cfg.n_layers % p


def _stack_into(dst: Optional[Dict], src: Dict, r: int, n: int) -> Dict:
    """Write repeat r of a tree into the stacked tree `dst` (allocated on
    the first repeat), so that the whole stack never exists twice."""
    if dst is None:
        dst = tree_map(lambda x: _empty_stack(x, n), src)

    def put(d, s):
        for key, val in s.items():
            if isinstance(val, dict):
                put(d[key], val)
            else:
                d[key][r].copy_(val)
    put(dst, src)
    return dst


def _empty_stack(x: torch.Tensor, n: int) -> torch.Tensor:
    """An uninitialised (n, *x.shape) stack like `x`; a DTensor's stack
    keeps its placements on the shifted dims (each rank allocates its
    own shard)."""
    def empty(t):
        return torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                           device=t.device)
    if not is_dtensor(x):
        return empty(x)
    return on_local(empty, x, split=range(x.dim()), place=[
        Shard(p.dim + 1) if p.is_shard() else p for p in x.placements])


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random parameters on `gen.device`, in the order of the module
    docstring."""
    dtype = _dtype(cfg.param_dtype)
    unit, n_rep, n_rem = stack_layout(cfg)
    dev = gen.device
    v = padded_vocab(cfg)
    params: Dict[str, Any] = {
        "embed": (torch.randn((v, cfg.d_model), generator=gen, device=dev,
                              dtype=torch.float32) * 0.02).to(dtype),
        "ln_f": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = (torch.randn(
            (cfg.d_model, v), generator=gen, device=dev, dtype=torch.float32)
            * (cfg.d_model ** -0.5)).to(dtype)
    blocks = None
    for r in range(n_rep):
        sup = {f"b{i}": init_block(gen, cfg, kind, is_moe)
               for i, (kind, is_moe) in enumerate(unit)}
        blocks = _stack_into(blocks, sup, r, n_rep)
        del sup
    if blocks is not None:
        params["blocks"] = blocks
    for r in range(n_rem):
        kind, is_moe = unit[r]
        params[f"rem{r}"] = init_block(gen, cfg, kind, is_moe)
    return params


def _embed(params: Dict, cfg: ModelConfig, tokens, embeds) -> torch.Tensor:
    """Token embeddings in the compute dtype, laid out as "act_btd".  A
    DTensor table is looked up on its shards (`_lookup_split`)."""
    dtype = _dtype(cfg.compute_dtype)
    with tracing.span("lm.embed"):
        if embeds is not None:
            return shard(embeds.to(dtype), "act_btd")
        table = params["embed"]
        if not is_dtensor(table):
            return shard(table[tokens.long()].to(dtype), "act_btd")
        x = shard(_lookup_split(table, tokens.long(), dtype), "act_btd")
        # no rule: summed here
        if any(p.is_partial() for p in x.placements):
            x = lay_out(x, x.device_mesh, [
                Replicate() if p.is_partial() else p for p in x.placements])
        return x


def _lookup_split(table: torch.Tensor, ids: torch.Tensor,
                  dtype) -> torch.Tensor:
    """table[ids] in `dtype` for a DTensor table (V, d), a vocab-parallel
    embedding: each rank looks its ids up in the vocabulary rows it
    holds, zero for the others, so the result is a partial sum over the
    mesh dims that split the vocabulary (one rank adds each value: exact
    in any dtype).  A mesh dim that splits the ids (a DTensor, the batch
    rows) splits the result's rows alike and must hold the table whole
    there (FSDP's gather of the table's d, or of its rows); one that
    splits only the table's d splits the result's.  So the reduction
    moves each rank's rows of (B, S, d), never the table, and no rank
    looks up rows it does not hold.  Plain ids are whole on every rank."""
    ids_place = (ids.placements if is_dtensor(ids)
                 else [Replicate()] * table.device_mesh.ndim)
    table = lay_out(table, table.device_mesh, [
        Replicate() if q.is_shard() else p
        for p, q in zip(table.placements, ids_place)])
    size, off = local_box(table)

    def lookup(t, ids):
        local = ids - off[0]
        hit = (local >= 0) & (local < size[0])
        rows = t[local.clamp(0, size[0] - 1)].to(dtype)
        return torch.where(hit[..., None], rows, 0.0)
    place = [q if q.is_shard() else Partial() if p.is_shard(0)
             else Shard(2) if p.is_shard(1) else p
             for p, q in zip(table.placements, ids_place)]
    return on_local(lookup, table, ids, split=(0, 1), place=place)


def _head(params: Dict, cfg: ModelConfig, x: torch.Tensor,
          layout: Optional[str] = None) -> torch.Tensor:
    """Final norm, LM head (its product laid out by `layout` where the
    reference names one), softcap."""
    with tracing.span("lm.head"):
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        logits = mm(x, head)
        if layout is not None:
            logits = shard(logits, layout)
        return softcap(logits, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Forward (prefill / evaluation)
# ---------------------------------------------------------------------------

REMAT = ("none", "dots", "full")
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the projections' matmul outputs, recompute the rest."""
    if op in _SAVED_BY_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, remat: str):
    """`fn` run under the checkpoint `remat` names (module docstring)."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    if remat == "none":
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def forward(params: Dict, cfg: ModelConfig, *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            window_override: Optional[int] = None,
            remat: str = "none", use_flash: Optional[bool] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, Vpad), aux_loss scalar).  `remat`
    rematerialises each stacked repeat (module docstring); the attention
    window is `window_override`, else the pattern's (`_window`)."""
    x = _embed(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    unit, n_rep, n_rem = stack_layout(cfg)
    window = (window_override if window_override is not None
              else _window(cfg, unit))

    def super_fwd(lp, x, aux):
        for i, (kind, is_moe) in enumerate(unit):
            x, a = block_forward(lp[f"b{i}"], x, positions, cfg, kind,
                                 is_moe, window if kind == "attn" else None,
                                 use_flash=use_flash)
            aux = aux + a
        return x, aux

    body = _maybe_remat(super_fwd, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if n_rep > 0:
        repeats = tree_map(lambda t: t.unbind(0), params["blocks"])
        for r in range(n_rep):
            x, aux = body(tree_map(lambda t: t[r], repeats), x, aux)
    for r in range(n_rem):
        kind, is_moe = unit[r]
        x, a = block_forward(params[f"rem{r}"], x, positions, cfg, kind,
                             is_moe, window if kind == "attn" else None,
                             use_flash=use_flash)
        aux = aux + a
    return _head(params, cfg, x, "act_btv"), aux


def block_prefill(params: Dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, kind: str, is_moe: bool,
                  window: Optional[int], cache_len: int, cache_dtype, *,
                  use_flash: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    # the norm's output is handed to the mixer, not held here: the
    # mixer drops it once projected, before attention's or the SSD's peak
    norm = functools.partial(rms_norm, x, params["ln1"], cfg.norm_eps)
    if kind == "attn":
        clen = min(cache_len, window) if window is not None else cache_len
        with tracing.span("lm.attn"):
            mixed, cache = attn_mod.attention_prefill(
                params["mix"], norm(), positions, cfg, clen, window=window,
                cache_dtype=cache_dtype, use_flash=use_flash)
    elif kind == "rec":
        mixed, cache = rglru_mod.rglru_forward(params["mix"], norm(), cfg,
                                               return_cache=True)
    else:
        mixed, cache = ssm_mod.ssm_forward(params["mix"], norm(), cfg,
                                           return_cache=True)
    del norm                    # holds x, which the residual frees
    x = shard(x + shard(mixed, "act_btd"), "act_btd")
    del mixed
    x, aux = _ffn(params, x, cfg, is_moe)
    return shard(x, "act_btd"), cache, aux


def prefill(params: Dict, cfg: ModelConfig, *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            cache_len: Optional[int] = None,
            cache_dtype=torch.bfloat16, use_flash: Optional[bool] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Full forward emitting (last-position logits, decode-ready cache)."""
    x = _embed(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    if cache_len is None:
        cache_len = s
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    unit, n_rep, n_rem = stack_layout(cfg)
    window = _window(cfg, unit)

    # the residual stream is handed to each block out of a list, so that
    # the block holds its input alone and frees it once the mixer's
    # output is added (a local here would hold it through the FFN)
    stream = [x]
    del x
    cache: Dict[str, Any] = {}
    stacked = None
    for r in range(n_rep):
        lp = _index(params["blocks"], r)
        caches = {}
        for i, (kind, is_moe) in enumerate(unit):
            out, caches[f"b{i}"], _ = block_prefill(
                lp[f"b{i}"], stream.pop(), positions, cfg, kind, is_moe,
                window if kind == "attn" else None, cache_len, cache_dtype,
                use_flash=use_flash)
            stream.append(out)
            del out
        stacked = _stack_into(stacked, caches, r, n_rep)
    if stacked is not None:
        cache["blocks"] = stacked
    for r in range(n_rem):
        kind, is_moe = unit[r]
        out, cache[f"rem{r}"], _ = block_prefill(
            params[f"rem{r}"], stream.pop(), positions, cfg, kind, is_moe,
            window if kind == "attn" else None, cache_len, cache_dtype,
            use_flash=use_flash)
        stream.append(out)
        del out
    logits = _head(params, cfg, stream.pop()[:, -1:])
    return logits[:, 0, :], cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(batch: int, cache_len: int, cfg: ModelConfig,
               dtype=torch.bfloat16, device="cuda") -> Dict:
    """Zeroed decode caches, stacked as the parameters are, on `device`
    (default the card; raises without one).  Attention caches of hybrid
    patterns hold min(cache_len, local_window) slots."""
    unit, n_rep, n_rem = stack_layout(cfg)
    device = resolve_device(device)
    window = _window(cfg, unit)

    def one(kind):
        clen = cache_len if kind != "attn" or window is None \
            else min(cache_len, window)
        return init_block_cache(batch, clen, cfg, kind, dtype, device)

    cache: Dict[str, Any] = {}
    if n_rep > 0:
        cache["blocks"] = {f"b{i}": tree_map(
            lambda x: torch.zeros((n_rep,) + tuple(x.shape), dtype=x.dtype,
                                  device=x.device), one(kind))
            for i, (kind, _) in enumerate(unit)}
    for r in range(n_rem):
        cache[f"rem{r}"] = one(unit[r][0])
    return cache


def decode_step(params: Dict, cache: Dict, tokens_t: torch.Tensor, pos,
                cfg: ModelConfig, *,
                embeds_t: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """One token for the whole batch.  tokens_t: (B,) ids; pos an int, a
    0-d tensor or (B,) per-slot positions.  Updates `cache` in place and
    returns (logits (B, Vpad), cache)."""
    x = _embed(params, cfg, None if tokens_t is None else tokens_t[:, None],
               embeds_t)
    unit, n_rep, n_rem = stack_layout(cfg)
    window = _window(cfg, unit)
    for r in range(n_rep):
        lp, lc = _index(params["blocks"], r), _index(cache["blocks"], r)
        for i, (kind, is_moe) in enumerate(unit):
            x, _ = block_decode(lp[f"b{i}"], x, lc[f"b{i}"], pos, cfg, kind,
                                is_moe, window if kind == "attn" else None)
    for r in range(n_rem):
        kind, is_moe = unit[r]
        x, _ = block_decode(params[f"rem{r}"], x, cache[f"rem{r}"], pos, cfg,
                            kind, is_moe, window if kind == "attn" else None)
    return _head(params, cfg, x)[:, 0, :], cache
