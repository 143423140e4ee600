"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), as
`repro/models/rglru.py`.

Real-gated linear recurrent unit:
    r_t = sigmoid(W_a u_t)                (recurrence gate)
    i_t = sigmoid(W_x u_t)                (input gate)
    log a_t = -c * softplus(Lambda) * r_t (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Block: two branches - GeLU(W1 x) (the tanh approximation, `jax.nn.gelu`'s
default) and conv1d -> RG-LRU(W2 x) - merged multiplicatively, then
projected out.  The forward runs the recurrence h_t = a_t h_{t-1} + b_t as
a log-depth scan in plain torch (`linear_scan`: ceil(log2 S) steps of the
combine (a_l a_r, a_r b_l + b_r)), where the reference calls
`jax.lax.associative_scan`; the two associate the products differently,
so they agree to float rounding.  Decode is the one-step recurrence with a
(B, width) state.  This block holds no kernel in the reference and stays
plain PyTorch.

`init_rglru` draws, from one generator on its device: w_y, w_u, conv_w,
w_a, w_x, w_o; `lam` is the constant 2.0.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import init_dense, mm
from repro_torch.sharding.api import is_dtensor, lay_out, on_local, seq_whole

_C = 8.0


def _width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    w = _width(cfg)
    d = cfg.d_model
    dev = gen.device
    return {
        "w_y": init_dense(gen, d, w, dtype),
        "w_u": init_dense(gen, d, w, dtype),
        "conv_w": (torch.randn((cfg.conv_kernel, w), generator=gen,
                               device=dev, dtype=torch.float32)
                   / math.sqrt(cfg.conv_kernel)).to(dtype),
        "w_a": init_dense(gen, w, w, dtype),
        "w_x": init_dense(gen, w, w, dtype),
        "lam": torch.full((w,), 2.0, dtype=torch.float32, device=dev),
        "w_o": init_dense(gen, w, d, dtype),
    }


def _gates(params: Dict, u: torch.Tensor):
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, float32."""
    r = torch.sigmoid(mm(u, params["w_a"]).to(torch.float32))
    i = torch.sigmoid(mm(u, params["w_x"]).to(torch.float32))
    log_a = -_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, beta * (i * u.to(torch.float32))


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  u: (B, S, C), w: (K, C).  A DTensor u
    (its sequence whole) is convolved on each rank's rows and channels,
    w's channels split as u's (the card's torch 2.11 raises in DTensor's
    rule for `F.pad`)."""
    if is_dtensor(u):
        w = lay_out(w, u.device_mesh, [
            Shard(1) if p.is_shard(2) else Replicate() for p in u.placements])
        return on_local(_causal_conv, u, w, split=(0, 2))
    k, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[i]
    return out


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All h_t of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis 1, by a
    log-depth (Hillis-Steele) scan: step d combines each element with the
    one d before it, (a, b) <- (a_{t-d} a_t, a_t b_{t-d} + b_t)."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                  return_cache: bool = False):
    """Full-sequence forward.  x: (B, S, d)."""
    x = seq_whole(x)
    y = F.gelu(mm(x, params["w_y"]), approximate="tanh")
    u_in = mm(x, params["w_u"])
    u = _causal_conv(u_in, params["conv_w"])
    a, b = _gates(params, u)                       # (B, S, W) f32
    if is_dtensor(a):               # on each rank's rows and channels
        h = on_local(linear_scan, a, lay_out(b, a.device_mesh, a.placements),
                     split=(0, 2))
    else:
        h = linear_scan(a, b)
    out = mm(y * h.to(x.dtype), params["w_o"])
    if not return_cache:
        return out
    k = cfg.conv_kernel
    cache = {"h": h[:, -1],
             "conv": u_in[:, -(k - 1):, :]}        # conv history tail
    return out, cache


def init_rglru_cache(batch: int, cfg: ModelConfig, dtype=torch.float32,
                     device="cuda") -> Dict:
    """Zeroed state and conv history on `device` (default the card)."""
    w = _width(cfg)
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, w), dtype=dtype,
                            device=dev),
    }


def rglru_decode(params: Dict, x_t: torch.Tensor, cache: Dict,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One token.  x_t: (B, 1, d).  Updates `cache` in place and returns
    (out, cache)."""
    y = F.gelu(mm(x_t, params["w_y"]), approximate="tanh")
    u_in = mm(x_t, params["w_u"])                   # (B, 1, W)
    hist = torch.cat([cache["conv"], u_in], dim=1)
    u = torch.sum(hist * params["conv_w"][None], dim=1, keepdim=True)
    a, b = _gates(params, u)                        # (B, 1, W)
    h = a[:, 0] * cache["h"] + b[:, 0]
    out = mm(y * h[:, None].to(x_t.dtype), params["w_o"])
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:, :])
    return out, cache
