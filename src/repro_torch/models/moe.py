"""Mixture-of-Experts FFN with group-local capacity dispatch, as
`repro/models/moe.py`.

Tokens are routed (float32 router, softmax, top-k, weights renormalised),
then dispatched per data-parallel group: within each group the (token,
choice) slots are sorted by expert (a stable sort, as `jnp.argsort`), each
slot takes the next free row of its expert's buffer of `capacity` rows,
and slots past an expert's capacity are dropped (the residual passes
through).  Dropped slots are written to one sentinel row past the last
expert's buffer, which is then cut off, so no two slots write one real
row.  The experts run as batched SwiGLU GEMMs over (groups, experts,
capacity, d); the combine gathers each kept slot's output, weights it by
its gate and sums the k choices of each token (`index_add_`, the
reference's `segment_sum`; on the card by atomics, so the order of a
token's at most top-k summands is not fixed).

Ties: `lax.top_k` takes the lower expert index on equal probabilities;
here a stable descending sort does.  The group count is the active
sharding policy's `dp_groups` hint (1 with none), shrunk for small
batches by `effective_groups`; `capacity` and `effective_groups` are the
reference's integer arithmetic.  The Switch load-balancing loss is
returned beside the output.

Under a sharding policy whose mesh carries DTensors, the routing, the
dispatch and the combine - integer bookkeeping DTensor has no rules for
(sorts, `searchsorted`, scatters) - run on plain tensors.  Where each
rank holds one dispatch group's rows (the batch split over the mesh dims
the `dp_groups` hint counts, as in training), each rank routes,
dispatches and combines its own rows (`_moe_on_rows`): the reference's
groups are batch-local.  Otherwise (decode's small batches, whose groups
shrink) they run whole on every rank (`sharding.api.whole`), and what
leaves that plain region is wrapped back as a replicated DTensor, which
keeps the gradient whole.  Either way the dispatch buffer and the
experts' output are laid out by "act_gecd" (groups on the batch axes,
experts on "model") and the expert GEMMs run on each rank's groups and
experts (`_experts`), as the reference's annotations place them.

This block holds no kernel in the reference and stays plain PyTorch.
`init_moe` draws, from one generator on its device: the router, the
experts' gate, up and down stacks, then the shared expert (gate, up,
down) where the config has one.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (einsum, init_dense, mm, swiglu_ffn,
                                       swiglu_ffn_init)
from repro_torch.sharding.api import (get_meta, is_dtensor, lay_out,
                                      on_local, replicated, seq_whole,
                                      shard, whole)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=gen.device,
                            dtype=torch.float32) * scale).to(dtype)
    params = {
        "router": init_dense(gen, d, e, torch.float32),
        "gate": normal((e, d, f), 1.0 / math.sqrt(d)),
        "up": normal((e, d, f), 1.0 / math.sqrt(d)),
        "down": normal((e, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.shared_expert:
        params["shared"] = swiglu_ffn_init(gen, d, f, dtype)
    return params


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    if c >= 8:
        return -(-c // 8) * 8       # pad to 8 for layout friendliness
    return max(1, c)                # decode-sized groups: no padded floor


def effective_groups(n_tokens: int, g: int) -> int:
    """Shrink the group count for small token batches (decode), where
    per-group capacity padding would multiply the experts' work."""
    while g > 1 and (n_tokens % g or n_tokens // g < 64):
        g //= 2
    return g


def _route(params: Dict, xf: torch.Tensor, k: int):
    """Router probabilities (T, E) in float32 and the top-k choices:
    weights renormalised over the k, the lower index first on ties."""
    probs = _probs(params["router"], xf)
    gate_w, gate_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_i = gate_w[:, :k], gate_i[:, :k]
    return probs, gate_w / gate_w.sum(dim=-1, keepdim=True), gate_i


def _probs(router: torch.Tensor, xf: torch.Tensor) -> torch.Tensor:
    return torch.softmax(mm(xf.to(torch.float32), router), dim=-1)


def _slots(gate_i: torch.Tensor, g: int, e: int, cap: int):
    """Each group's (token, choice) slots sorted by expert (stable), and
    the buffer row each takes: (order, token of each slot, kept, row);
    a dropped slot's row is the sentinel e * cap."""
    k = gate_i.shape[-1]
    ei = gate_i.reshape(g, -1)
    dev = ei.device
    order = torch.argsort(ei, dim=-1, stable=True)
    se = torch.gather(ei, 1, order).contiguous()
    st = order // k                                       # token of slot
    seg_starts = torch.searchsorted(
        se, torch.arange(e, device=dev).expand(g, e).contiguous())
    rank = torch.arange(ei.shape[1], device=dev) - torch.gather(
        seg_starts, 1, se)
    keep = rank < cap
    dest = torch.where(keep, se * cap + rank, e * cap)   # e * cap: sentinel
    return order, st, keep, dest


def _dispatch(xg: torch.Tensor, st, dest, e: int, cap: int) -> torch.Tensor:
    """The dispatch buffer (g, E, C, d) of the groups' tokens xg (g, tl,
    d): each kept slot's token in its row, the sentinel row cut off."""
    g, _, d = xg.shape
    rows = torch.arange(g, device=xg.device)[:, None]
    buf = xg.new_zeros((g, e * cap + 1, d))
    buf[rows, dest] = xg[rows, st]
    return buf[:, :e * cap].reshape(g, e, cap, d)


def _combine(y: torch.Tensor, ew, order, keep, dest, st, tl: int
             ) -> torch.Tensor:
    """(g * tl, d): each token's kept slots' expert outputs y (g, E, C,
    d), weighted by their gates ew (g, tl * k), summed over its k choices
    (`index_add_`, the reference's `segment_sum`)."""
    g, e, cap, d = y.shape
    yf = torch.cat([y.reshape(g, e * cap, d), y.new_zeros((g, 1, d))],
                   dim=1)
    rows = torch.arange(g, device=y.device)[:, None]
    w = torch.where(keep, torch.gather(ew, 1, order), 0.0)
    contrib = yf[rows, dest] * w[..., None]
    return contrib.new_zeros((g * tl, d)).index_add_(
        0, (rows * tl + st).reshape(-1), contrib.reshape(-1, d))


def moe_ffn(params: Dict, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    g = effective_groups(t, get_meta("dp_groups", 1))
    tl = t // g
    cap = capacity(tl, cfg)
    if is_dtensor(x):
        x = seq_whole(x)
        rows = _group_rows(x, g)
        if rows is not None:
            out, aux = _moe_on_rows(params, x, cfg, rows, g, cap)
            if cfg.shared_expert:
                out = out + swiglu_ffn(params["shared"], x)
            return out, aux
    mesh = x.device_mesh if is_dtensor(x) else None
    shared_in = x
    x = whole(x)
    xf = x.reshape(t, d)
    probs, gate_w, gate_i = _route({"router": whole(params["router"])},
                                   xf, k)

    # load-balancing auxiliary loss (Switch-style; global statistics)
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_i[:, 0], e).to(torch.float32).mean(dim=0)
    aux = e * torch.sum(me * ce)

    # ---- group-local dispatch ----
    order, st, keep, dest = _slots(gate_i, g, e, cap)
    buf = _dispatch(xf.reshape(g, tl, d), st, dest, e, cap)
    buf = shard(replicated(buf, mesh), "act_gecd")

    # ---- expert computation: batched GEMMs ----
    y = whole(shard(_experts(params, buf), "act_gecd"))

    # ---- group-local combine ----
    ew = gate_w.reshape(g, tl * k).to(x.dtype)
    out = _combine(y, ew, order, keep, dest, st, tl)
    out = replicated(out, mesh).reshape(b, s, d)
    if cfg.shared_expert:
        out = out + swiglu_ffn(params["shared"], shared_in)
    return out, replicated(aux, mesh)


def _group_rows(x: torch.Tensor, g: int):
    """The mesh dims that split the DTensor x (B, S, d)'s batch rows as
    the g dispatch groups are cut - each rank holding one group - and
    nothing else, or None."""
    place = x.placements
    rows = [j for j, p in enumerate(place) if p.is_shard(0)]
    if g == 1 or any(not p.is_replicate() for j, p in enumerate(place)
                     if j not in rows):
        return None
    ways = math.prod(x.device_mesh.size(j) for j in rows)
    return rows if ways == g else None


def _moe_on_rows(params: Dict, x: torch.Tensor, cfg: ModelConfig, rows,
                 g: int, cap: int):
    """`moe_ffn` where each rank holds one dispatch group's rows (mesh
    dims `rows`): routing, dispatch and combine on the rank's own tokens,
    as the reference's groups are batch-local; only the experts' GEMMs
    cross the expert split ("act_gecd").  The auxiliary loss keeps its
    global statistics: each rank's means of the router's probabilities
    and first choices, summed over the groups' ranks.  Returns (out
    (B, S, d) split as x, aux)."""
    mesh, e, k = x.device_mesh, cfg.n_experts, cfg.top_k
    b, s, d = x.shape
    tl = b * s // g
    split = [Shard(0) if j in rows else Replicate() for j in range(mesh.ndim)]
    whole_place = [Replicate()] * mesh.ndim
    share = [Partial() if j in rows else Replicate()
             for j in range(mesh.ndim)]
    probs = on_local(lambda xl, r: _probs(r, xl.reshape(tl, d)), x,
                     replicated(params["router"]), split=(0,), place=split)
    with torch.no_grad():           # the slots: integer bookkeeping
        gate_i = torch.sort(probs.to_local(), dim=-1, descending=True,
                            stable=True)[1][:, :k]
        order, st, keep, dest = _slots(gate_i, 1, e, cap)
        first = F.one_hot(gate_i[:, 0], e).to(torch.float32).mean(dim=0)
    me = lay_out(on_local(lambda p: p.mean(dim=0) / g, probs, split=(0,),
                          place=share), mesh, whole_place)
    ce = lay_out(DTensor.from_local(first / g, mesh, share,
                                    run_check=False), mesh, whole_place)
    aux = e * torch.sum(me * ce)

    buf = on_local(lambda xl: _dispatch(xl.reshape(1, tl, d), st, dest, e,
                                        cap), x, split=(0,), place=split)
    y = lay_out(shard(_experts(params, shard(buf, "act_gecd")),
                      "act_gecd"), mesh, split)

    def combine(yl, p):
        gate_w = torch.gather(p, 1, gate_i)
        ew = (gate_w / gate_w.sum(dim=-1, keepdim=True)).reshape(
            1, tl * k).to(x.dtype)
        return _combine(yl, ew, order, keep, dest, st, tl).reshape(
            b // g, s, d)
    return on_local(combine, y, probs, split=(0,), place=split), aux


def _experts(params: Dict, buf: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on the dispatch buffer (g, E, C, d).  A DTensor
    buffer is computed on each rank's block: the expert stacks are laid
    out with their expert axis split as the buffer's and the rest whole,
    and the local GEMMs' output keeps the buffer's placements."""
    def swiglu(x, gate, up, down):
        h = F.silu(einsum("gecd,edf->gecf", x, gate))
        h = h * einsum("gecd,edf->gecf", x, up)
        return einsum("gecf,efd->gecd", h, down)

    if not is_dtensor(buf):
        return swiglu(buf, params["gate"], params["up"], params["down"])
    split = [Shard(0) if p.is_shard(1) else Replicate()
             for p in buf.placements]
    stacks = [lay_out(params[name], buf.device_mesh, split)
              for name in ("gate", "up", "down")]
    return on_local(swiglu, buf, *stacks, split=(0, 1))


def dropped_slots(x: torch.Tensor, params: Dict, cfg: ModelConfig) -> int:
    """How many (token, choice) slots of x (B, S, d) `moe_ffn` drops for
    capacity: the number its dispatch sends to the sentinel row."""
    t = x.shape[0] * x.shape[1]
    g = effective_groups(t, get_meta("dp_groups", 1))
    cap = capacity(t // g, cfg)
    _, _, gate_i = _route({"router": whole(params["router"])},
                          whole(x).reshape(t, -1), cfg.top_k)
    counts = F.one_hot(gate_i.reshape(g, -1), cfg.n_experts).sum(dim=1)
    return int((counts - cap).clamp(min=0).sum())
