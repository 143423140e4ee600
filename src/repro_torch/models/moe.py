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
(sorts, `searchsorted`, scatters) - run on plain tensors whole on every
rank (`sharding.api.whole`); the dispatch buffer and the experts' output
are laid out by "act_gecd" (groups on the batch axes, experts on
"model"), and the expert GEMMs run on each rank's groups and experts
(`_experts`), as the reference's annotations place them.  What leaves a plain region is
wrapped back as a replicated DTensor, which keeps the gradient whole.

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
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (einsum, init_dense, mm, swiglu_ffn,
                                       swiglu_ffn_init)
from repro_torch.sharding.api import (get_meta, is_dtensor, lay_out,
                                      on_local, replicated, shard, whole)


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
    probs = torch.softmax(mm(xf.to(torch.float32), params["router"]), dim=-1)
    gate_w, gate_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_i = gate_w[:, :k], gate_i[:, :k]
    return probs, gate_w / gate_w.sum(dim=-1, keepdim=True), gate_i


def moe_ffn(params: Dict, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    g = effective_groups(t, get_meta("dp_groups", 1))
    tl = t // g
    cap = capacity(tl, cfg)
    mesh = x.device_mesh if is_dtensor(x) else None
    shared_in = x.reshape(t, d)
    x = whole(x)
    xf = x.reshape(t, d)
    probs, gate_w, gate_i = _route(dict(params, router=whole(
        params["router"])), xf, k)

    # load-balancing auxiliary loss (Switch-style; global statistics)
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_i[:, 0], e).to(torch.float32).mean(dim=0)
    aux = e * torch.sum(me * ce)

    # ---- group-local dispatch ----
    dev = x.device
    xg = xf.reshape(g, tl, d)
    ei = gate_i.reshape(g, tl * k)
    ew = gate_w.reshape(g, tl * k).to(x.dtype)
    order = torch.argsort(ei, dim=-1, stable=True)
    se = torch.gather(ei, 1, order).contiguous()
    st = order // k                                       # token of slot
    seg_starts = torch.searchsorted(
        se, torch.arange(e, device=dev).expand(g, e).contiguous())
    rank = torch.arange(tl * k, device=dev) - torch.gather(seg_starts, 1, se)
    keep = rank < cap
    dest = torch.where(keep, se * cap + rank, e * cap)   # e * cap: sentinel
    rows = torch.arange(g, device=dev)[:, None]
    buf = x.new_zeros((g, e * cap + 1, d))
    buf[rows, dest] = xg[rows, st]
    buf = shard(replicated(buf[:, :e * cap].reshape(g, e, cap, d), mesh),
                "act_gecd")

    # ---- expert computation: batched GEMMs ----
    y = whole(shard(_experts(params, buf), "act_gecd"))

    # ---- group-local combine ----
    yf = torch.cat([y.reshape(g, e * cap, d), y.new_zeros((g, 1, d))],
                   dim=1)
    w = torch.where(keep, torch.gather(ew, 1, order), 0.0)
    contrib = yf[rows, dest] * w[..., None]
    out = contrib.new_zeros((g * tl, d)).index_add_(
        0, (rows * tl + st).reshape(-1), contrib.reshape(-1, d))

    out = replicated(out, mesh)
    if cfg.shared_expert:
        out = out + swiglu_ffn(params["shared"], shared_in)
    return out.reshape(b, s, d), replicated(aux, mesh)


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
