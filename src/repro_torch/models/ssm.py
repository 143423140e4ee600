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

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import init_dense, mm, rms_norm
from repro_torch.sharding.api import (is_dtensor, lay_out, on_local,
                                      replicated, whole)


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
    """Chunked SSD, full sequence.  x: (B, S, d) -> (B, S, d).  Under a
    mesh the SSD runs on each rank's batch rows, the in-projection's
    features gathered, and the ranks that share those rows share out the
    heads (`_head_share`: ceil(H / m) a rank, where an even split over
    the model axis need not exist: mamba2's 24 heads on 16); the
    projections stay on DTensors."""
    d_inner, h, _, _ = _dims(cfg)
    zxbcdt = mm(_rows_apart(x, params["in_proj"]), params["in_proj"])
    weights = [params[k] for k in ("conv_w", "dt_bias", "a_log", "d_skip")]
    norm_w = params["norm_w"]
    if not is_dtensor(zxbcdt):
        y, state, conv = _forward_core(zxbcdt, *weights, cfg, (0, h, h))
        y = _gate(y, zxbcdt, norm_w, cfg, x.dtype)
    else:
        mesh = zxbcdt.device_mesh
        rows = [p if p.is_shard(0) else Replicate()
                for p in zxbcdt.placements]
        zxbcdt = lay_out(zxbcdt, mesh, rows)
        heads, by_head, by_state = _head_share(mesh, rows, h)
        y, state, conv = on_local(
            functools.partial(_forward_core, heads=heads), zxbcdt,
            *(replicated(w, mesh) for w in weights), cfg, split=(0,),
            place=(by_head, by_state, rows))
        y = on_local(lambda t, zx, w: _gate(t[:, :, :h], zx, w, cfg,
                                            x.dtype),
                     lay_out(y, mesh, rows), zxbcdt, replicated(norm_w, mesh),
                     split=(0,), place=rows)
        state = on_local(lambda t: t[:, :h], lay_out(state, mesh, rows),
                         split=(0,))
    out = mm(y, params["out_proj"])
    if not return_cache:
        return out
    return out, {"state": state, "conv": conv}


def _rows_apart(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) with its sequence split (a local slice) over each mesh
    dim that splits neither its rows nor the weight w, so that the
    product x @ w is not repeated on every rank there: mamba2's in
    projection of 3352 features is whole on a 16-wide "model" axis (the
    parameter rules keep a dim they cannot split evenly whole), and the
    core gathers the sequence back."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x
    mesh, s = x.device_mesh, x.shape[1]
    place, ways = list(x.placements), 1
    for j, (p, q) in enumerate(zip(x.placements, w.placements)):
        if p.is_replicate() and q.is_replicate() and \
                s % (ways * mesh.size(j)) == 0:
            place[j], ways = Shard(1), ways * mesh.size(j)
    return lay_out(x, mesh, place)


def _head_share(mesh, rows, h: int):
    """This rank's heads of h where the mesh dims that do not split the
    rows (`rows`: placements) share them out: ceil(h / m) a rank over
    those m ranks, the last ones short or empty.  ((first, end, width),
    the placements of a (B, S, m * width, P) stack of every rank's padded
    heads, and of a (B, m * width, P, N) one)."""
    over = [j for j, p in enumerate(rows) if p.is_replicate()]
    coord, m, r = mesh.get_coordinate(), 1, 0
    for j in over:
        r, m = r * mesh.size(j) + coord[j], m * mesh.size(j)
    width = -(-h // m)
    first = min(r * width, h)
    return ((first, min(first + width, h), width),
            [Shard(2) if j in over else p for j, p in enumerate(rows)],
            [Shard(1) if j in over else p for j, p in enumerate(rows)])


def _gate(y, zxbcdt, norm_w, cfg: ModelConfig, dtype):
    """The gated RMSNorm of the SSD's y (B, S, H, P) float32 with z, the
    in-projection's first d_inner features, in `dtype` (the out
    projection follows)."""
    b, s = y.shape[:2]
    d_inner = _dims(cfg)[0]
    y = y.reshape(b, s, d_inner).to(dtype)
    return rms_norm(y * F.silu(zxbcdt[..., :d_inner]), norm_w, cfg.norm_eps)


def _forward_core(zxbcdt, conv_w, dt_bias, a_log, d_skip,
                  cfg: ModelConfig, heads):
    """The SSD of plain tensors from the in-projection (B, S, F), for
    heads [first, end) of `heads` = (first, end, width): (y (B, S, width,
    P) float32 with the skip term, the last state (B, width, P, N), the
    conv history's tail), heads past `end` zero.  All heads (0, H, H) is
    the reference's SSD op for op."""
    b, s, _ = zxbcdt.shape
    d_inner, h, p, n = _dims(cfg)
    first, end, width = heads
    f32 = torch.float32
    _, xs, bc, dt = torch.split(zxbcdt, [d_inner, d_inner, 2 * n, h],
                                dim=-1)
    conv_in = torch.cat([xs, bc], dim=-1)
    conv_out = _causal_conv(conv_in, conv_w)
    xs, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)
    xh = xs.reshape(b, s, h, p)[:, :, first:end]
    h = end - first
    dt = F.softplus(dt[..., first:end].to(f32)
                    + dt_bias[first:end])                      # (B, S, H)
    a = -torch.exp(a_log[first:end])                           # (H,)
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
    mask = torch.ones((ch, ch), dtype=torch.bool,
                      device=zxbcdt.device).tril()
    decay = torch.exp(torch.where(mask[:, :, None], diff, -math.inf))
    cb = torch.einsum("bcin,bcjn->bcij", cmat_c, bmat_c)      # (B,NC,i,j)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay,
                           xbar)

    # ---- inter-chunk states ----
    # state_c = sum_j exp(total - cum_j) * B_j^T xbar_j
    w_in = torch.exp(total[:, :, None, :] - cum)               # (B,NC,ch,H)
    state_c = torch.einsum("bcjn,bcjhp->bchpn", bmat_c,
                           xbar * w_in[..., None])             # (B,NC,H,P,N)
    state = torch.zeros((b, h, p, n), dtype=f32, device=zxbcdt.device)
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
    y = y + d_skip[first:end, None] * xh.to(f32)
    conv = conv_in[:, -(cfg.conv_kernel - 1):, :]
    if h < width:                   # a rank's short share of the heads
        y = F.pad(y, (0, 0, 0, width - h))
        state = F.pad(state, (0, 0, 0, 0, 0, width - h))
    return y, state, conv


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
