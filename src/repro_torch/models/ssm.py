"""Mamba-2 SSD (state-space duality) layer (arXiv:2405.21060), as
`repro/models/ssm.py`.

The forward uses the chunked SSD algorithm: the sequence is split into
chunks; within a chunk the output is a masked quadratic form (the
'attention mode' of the duality), across chunks a compact (H, P, N) state
is passed recurrently (the 'SSM mode', a Python loop over the chunks where
the reference has `lax.scan`).  Decode carries the state one token at a
time.  Per-head scalar A, one B/C group, a depthwise conv on the (x, B, C)
projections and a gated RMSNorm output, as the reference.  This block
holds no kernel in the reference and stays plain PyTorch.

One difference, by design: the intra-chunk decay exp(cum_i - cum_j) is
masked before the exponential (exp of -inf above the diagonal), where the
reference takes the exponential of every (i, j) and zeroes the upper
triangle after it.  Above the diagonal cum_i - cum_j > 0 can overflow to
inf; the forward is the same either way, but a gradient through the
reference's form can meet 0 * inf, and through this one it stays finite.

`init_ssm` draws, from one generator on its device: in_proj, conv_w,
out_proj; a_log, dt_bias, norm_w are zeros and d_skip ones.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import init_dense, mm, rms_norm
from repro_torch.sharding.api import is_dtensor, lay_out, on_local, whole


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    d_inner, h, p, n = _dims(cfg)
    d = cfg.d_model
    dev = gen.device
    conv_dim = d_inner + 2 * n   # conv over (x, B, C)

    def f32(fill, size):
        return torch.full((size,), fill, dtype=torch.float32, device=dev)
    return {
        # in_proj emits (z, x, B, C, dt)
        "in_proj": init_dense(gen, d, 2 * d_inner + 2 * n + h, dtype),
        "conv_w": (torch.randn((cfg.conv_kernel, conv_dim), generator=gen,
                               device=dev, dtype=torch.float32)
                   / math.sqrt(cfg.conv_kernel)).to(dtype),
        "a_log": f32(0.0, h),
        "dt_bias": f32(0.0, h),
        "d_skip": f32(1.0, h),
        "norm_w": f32(0.0, d_inner),
        "out_proj": init_dense(gen, d_inner, d, dtype),
    }


def _split_proj(params: Dict, x: torch.Tensor, cfg: ModelConfig):
    d_inner, h, p, n = _dims(cfg)
    zxbcdt = mm(x, params["in_proj"])
    return torch.split(zxbcdt, [d_inner, d_inner, 2 * n, h], dim=-1)


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, then SiLU.  u: (B, S, C), w: (K, C)."""
    k, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out)


def ssm_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                return_cache: bool = False):
    """Chunked SSD, full sequence.  x: (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    d_inner, h, p, n = _dims(cfg)
    f32 = torch.float32
    z, xs, bc, dt = _split_proj(params, x, cfg)
    conv_in = torch.cat([xs, bc], dim=-1)
    conv_out = _causal_conv(conv_in, params["conv_w"])
    xs, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)
    xh = xs.reshape(b, s, h, p)
    dt = F.softplus(dt.to(f32) + params["dt_bias"])           # (B, S, H)
    a = -torch.exp(params["a_log"])                            # (H,)
    la = dt * a                            # log decay per step, <= 0
    xbar = xh * dt[..., None].to(xh.dtype)

    ch = min(cfg.ssm_chunk, s)
    if s % ch:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSD chunk {ch}")
    nc = s // ch
    xbar = xbar.reshape(b, nc, ch, h, p).to(f32)
    bmat_c = bmat.reshape(b, nc, ch, n).to(f32)
    cmat_c = cmat.reshape(b, nc, ch, n).to(f32)
    cum = torch.cumsum(la.reshape(b, nc, ch, h), dim=2)        # (B,NC,ch,H)
    total = cum[:, :, -1, :]                                   # (B,NC,H)

    # ---- intra-chunk (quadratic / 'attention' mode) ----
    # L[i, j] = exp(cum_i - cum_j) for i >= j, masked before the exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,NC,i,j,H)
    mask = torch.ones((ch, ch), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(mask[:, :, None], diff, -math.inf))
    cb = torch.einsum("bcin,bcjn->bcij", cmat_c, bmat_c)      # (B,NC,i,j)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay,
                           xbar)

    # ---- inter-chunk states ----
    # state_c = sum_j exp(total - cum_j) * B_j^T xbar_j
    w_in = torch.exp(total[:, :, None, :] - cum)               # (B,NC,ch,H)
    state_c = torch.einsum("bcjn,bcjhp->bchpn", bmat_c,
                           xbar * w_in[..., None])             # (B,NC,H,P,N)
    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    in_states = []
    for c in range(nc):
        in_states.append(state)                        # incoming state
        state = state * torch.exp(total[:, c])[:, :, None, None] \
            + state_c[:, c]
    in_states = torch.stack(in_states, dim=1)                  # (B,NC,H,P,N)

    # ---- inter-chunk contribution: C_i exp(cum_i) state_in ----
    y_inter = torch.einsum("bcin,bchpn->bcihp", cmat_c, in_states) \
        * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(b, s, h, p)
    y = y + params["d_skip"][:, None] * xh.to(f32)
    y = y.reshape(b, s, d_inner).to(x.dtype)
    # gated RMSNorm then out projection
    y = rms_norm(y * F.silu(z), params["norm_w"], cfg.norm_eps)
    out = mm(y, params["out_proj"])
    if not return_cache:
        return out
    k = cfg.conv_kernel
    return out, {"state": state, "conv": conv_in[:, -(k - 1):, :]}


# ---------------------------------------------------------------------------
# Decode path: recurrent state + conv history
# ---------------------------------------------------------------------------

def init_ssm_cache(batch: int, cfg: ModelConfig, dtype=torch.float32,
                   device="cuda") -> Dict:
    """Zeroed state and conv history on `device` (default the card)."""
    d_inner, h, p, n = _dims(cfg)
    dev = resolve_device(device)
    return {
        "state": torch.zeros((batch, h, p, n), dtype=torch.float32,
                             device=dev),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, d_inner + 2 * n),
                            dtype=dtype, device=dev),
    }


def ssm_decode(params: Dict, x_t: torch.Tensor, cache: Dict,
               cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One token.  x_t: (B, 1, d).  Updates `cache` in place and returns
    (out, cache).  A DTensor cache runs on each rank's batch rows: the
    state, its conv history and the projections are laid out by the
    state's batch split (a cache laid out otherwise is written back
    after), and the recurrence runs on local tensors (DTensor's einsum
    rules would split the heads over the model axis unevenly)."""
    z, xs, bc, dt = _split_proj(params, x_t, cfg)
    state, conv = cache["state"], cache["conv"]
    weights = [params[k] for k in ("conv_w", "dt_bias", "a_log", "d_skip")]
    if is_dtensor(state):
        mesh = state.device_mesh
        rows = [p if p.is_shard(0) else Replicate() for p in state.placements]
        st, cv = (lay_out(t, mesh, rows) for t in (state, conv))
        y = on_local(_decode_core, st, cv,
                     *(lay_out(t, mesh, rows) for t in (xs, bc, dt)),
                     *(whole(w) for w in weights), cfg, split=(0,),
                     place=rows)
        for dst, src in ((state, st), (conv, cv)):
            if src is not dst:      # a cache laid out otherwise
                dst.copy_(src)
    else:
        y = _decode_core(state, conv, xs, bc, dt, *weights, cfg)
    y = rms_norm(y.to(x_t.dtype) * F.silu(z), params["norm_w"], cfg.norm_eps)
    return mm(y, params["out_proj"]), cache


def _decode_core(state, conv, xs, bc, dt, conv_w, dt_bias, a_log, d_skip,
                 cfg: ModelConfig) -> torch.Tensor:
    """The decode recurrence of plain tensors: the conv history and the
    state updated in place; returns y (B, 1, d_inner) in float32 before
    the gated norm."""
    b = xs.shape[0]
    d_inner, h, p, n = _dims(cfg)
    f32 = torch.float32
    hist = torch.cat([conv, torch.cat([xs, bc], dim=-1)], dim=1)
    conv_out = F.silu(torch.sum(hist * conv_w[None], dim=1, keepdim=True))
    xs, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)
    xh = xs.reshape(b, h, p)
    dt_t = F.softplus(dt[:, 0].to(f32) + dt_bias)             # (B, H)
    decay = torch.exp(dt_t * -torch.exp(a_log))                # (B, H)
    xbar = xh.to(f32) * dt_t[..., None]
    upd = torch.einsum("bn,bhp->bhpn", bmat[:, 0].to(f32), xbar)
    new_state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].to(f32), new_state)
    y = y + d_skip[:, None] * xh.to(f32)
    state.copy_(new_state)
    conv.copy_(hist[:, 1:, :])
    return y.reshape(b, 1, d_inner)
