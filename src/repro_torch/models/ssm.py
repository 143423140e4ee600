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
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import init_dense, mm, rms_norm
from repro_torch.sharding.api import (ceil_share, is_dtensor, lay_out,
                                      local_box, on_local, rank_among,
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
    mesh the SSD runs on each rank's batch rows, and the ranks that share
    those rows share out the H * P channels (`_head_share`: ceil(H P / m)
    a rank, mamba2's 1536 channels 96 a rank on 16, where its 24 heads
    split evenly over no 16-wide axis).  The in-projection runs on a
    share of the sequence (`_rows_apart`), and each rank gathers of it
    only what it needs: B, C and dt whole, z on its channels, x on the
    heads they touch (`_share_zx`: one all-to-all).  The conv runs on
    those x channels with B and C, the inter-chunk products on the
    rank's channels, the intra-chunk one on the heads they touch, the
    heads' shared C B^T on a share of the chunks (`_cb_shared`), the
    gated norm on the channel share (`_gate_share`), and the out
    projection on it, row-parallel; no rank holds the in-projection, y
    or the conv input whole.  The conv history in the cache is gathered
    from each rank's last rows (`_conv_tail`), laid out as decode keeps
    it."""
    d_inner, h, p, n = _dims(cfg)
    dtype = x.dtype
    zxbcdt = mm(_rows_apart(x, params["in_proj"]), params["in_proj"])
    del x                       # dead once projected
    weights = [params[k] for k in ("conv_w", "dt_bias", "a_log", "d_skip")]
    w_out = params["out_proj"]
    if not is_dtensor(zxbcdt):
        _, xs, bc, dt = torch.split(zxbcdt, [d_inner, d_inner, 2 * n, h],
                                    dim=-1)
        y, state = _forward_core(xs, bc, dt, *weights, cfg,
                                 (0, d_inner, d_inner))
        tail = -(cfg.conv_kernel - 1)   # a copy: no view of the whole input
        conv = torch.cat([xs[:, tail:], bc[:, tail:]], dim=-1)
        y = _gate(y, zxbcdt, params["norm_w"], cfg, dtype)
    else:
        mesh = zxbcdt.device_mesh
        zxbcdt = lay_out(zxbcdt, mesh, [      # its features whole
            Replicate() if p.is_shard(2) else p for p in zxbcdt.placements])
        rows = [p if p.is_shard(0) else Replicate()
                for p in zxbcdt.placements]
        chans, by_chan, by_state = _head_share(mesh, rows, d_inner)
        zx = _share_zx(zxbcdt, rows, chans, cfg)
        bcdt = lay_out(on_local(lambda t: t[..., 2 * d_inner:], zxbcdt,
                                split=range(3)), mesh, rows)
        conv = _conv_tail(zxbcdt, rows, cfg)
        del zxbcdt
        width = chans[2]

        def core(zx, bcdt, *weights):
            return _forward_core(zx[..., width:], bcdt[..., :2 * n],
                                 bcdt[..., 2 * n:], *weights, cfg, chans,
                                 _cb_shared(mesh, rows))
        y, state = on_local(core, zx, bcdt,
                            *(replicated(w, mesh) for w in weights),
                            split=(0, 2), place=(by_chan, by_state))
        del bcdt
        y = _gate_share(y, zx, params["norm_w"], cfg, dtype, rows, chans)
        del zx
        state = lay_out(state, mesh, rows)
        if y.shape[-1] != d_inner:      # a short last share: zero rows
            w_out = lay_out(w_out, mesh, [Replicate() if p.is_shard(0)
                                          else p for p in w_out.placements])
            w_out = on_local(lambda t: F.pad(t, (0, 0, 0, y.shape[-1]
                                                 - d_inner)),
                             w_out, split=(1,))
    state = _heads_of(state, h, p)
    out = mm(y, w_out)
    if not return_cache:
        return out
    return out, {"state": state, "conv": conv}


def _share_zx(zxbcdt: torch.Tensor, rows, chans, cfg: ModelConfig
              ) -> torch.Tensor:
    """Each rank's z channels [first, end) (padded to `width`) and the x
    channels of the heads they touch (padded to the widest such span),
    from the in-projection `zxbcdt` (a DTensor, its sequence split or
    whole): every rank cuts, from its own rows, the columns each rank of
    the channels' share needs, and one layout change moves them (an
    all-to-all over the dims that split the sequence; no communication
    where it is whole).  Returns a (B, S, m * (width + span)) DTensor laid
    out as `_head_share`'s channel stack: each rank's local block is its
    (B rows, S, width + span)."""
    mesh = zxbcdt.device_mesh
    d_inner, _, p, _ = _dims(cfg)
    over = [j for j, q in enumerate(rows) if q.is_replicate()]
    _, m = rank_among(mesh, over)
    width = chans[2]
    spans = []
    for r in range(m):
        first, end, _ = ceil_share(d_inner, r, m)
        h0, h1 = first // p, -(-end // p)
        spans.append(((first, end), (d_inner + h0 * p, d_inner + h1 * p)))
    span = max(b - a for _, (a, b) in spans)

    def cut(t):
        parts = []
        for (z0, z1), (x0, x1) in spans:
            for a, b, w in ((z0, z1, width), (x0, x1, span)):
                part = t[..., a:b]
                if b - a < w:
                    part = F.pad(part, (0, w - (b - a)))
                parts.append(part)
        return torch.cat(parts, dim=-1)
    return _seq_to_chans(on_local(cut, zxbcdt, split=range(2)), rows)


def _seq_to_chans(stack: torch.Tensor, rows) -> torch.Tensor:
    """A (B, S, m * W) DTensor, its sequence split or whole, laid out as
    `_head_share`'s channel stack (rank r of the m that share the
    channels holds columns [r W, (r + 1) W) with the sequence whole).
    Where one mesh dim splits the sequence and the channels, each rank
    sends each other rank its rows of that rank's columns in one
    all-to-all (DTensor's own layout change gathers the whole stack on a
    CPU mesh); any other layout is DTensor's."""
    from torch.distributed import _functional_collectives as funcol
    mesh = stack.device_mesh
    over = [j for j, q in enumerate(rows) if q.is_replicate()]
    target = [Shard(2) if j in over else q for j, q in enumerate(rows)]
    seq = [j for j, q in enumerate(stack.placements) if q.is_shard(1)]
    wide = [j for j in over if mesh.size(j) > 1]
    if not (len(seq) == 1 and wide == seq and all(
            q == r for j, (q, r) in enumerate(zip(stack.placements, rows))
            if j not in seq)):
        return lay_out(stack, mesh, target)
    j, m = seq[0], mesh.size(seq[0])
    swap = getattr(funcol, "all_to_all_single_autograd", None) or \
        funcol.all_to_all_single

    def move(t):                # rows to ranks by their columns' owner
        b, sl, f = t.shape
        send = t.reshape(b, sl, m, f // m).permute(2, 0, 1, 3).contiguous()
        got = swap(send, None, None, (mesh, j))    # (source rank, B, sl, W)
        return got.permute(1, 0, 2, 3).reshape(b, m * sl, f // m)
    return on_local(move, stack, split=(0, 1), place=target)


def _conv_tail(zxbcdt: torch.Tensor, rows, cfg: ModelConfig
               ) -> torch.Tensor:
    """The conv history a prefill leaves for decode: the last K - 1 rows
    of the conv input (x, B, C), laid out by `rows` (whole channels on
    every rank that holds the batch rows).  Where the sequence is split,
    each rank gives its own last min(K - 1, local rows) rows, those are
    gathered in order and the last K - 1 kept - never the whole input."""
    d_inner, _, _, n = _dims(cfg)
    k = cfg.conv_kernel - 1
    mesh = zxbcdt.device_mesh
    t = min(k, local_box(zxbcdt)[0][1])
    tails = on_local(lambda u: u[:, -t:, d_inner:2 * d_inner + 2 * n]
                     .clone(), zxbcdt, split=range(2))
    tails = lay_out(tails, mesh, rows)
    return on_local(lambda u: u[:, -k:], tails, split=(0,))


def _heads_of(state: torch.Tensor, h: int, p: int) -> torch.Tensor:
    """A (B, >= H*P, N) state of channels as the (B, H, P, N) cache (a
    DTensor's rows split alone, its channel padding cut)."""
    def cut(t):
        return t[:, :h * p].reshape(t.shape[0], h, p, t.shape[-1])
    if not is_dtensor(state):
        return cut(state)
    return on_local(cut, state, split=(0,))


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
    """This rank's share of h heads or channels where the mesh dims that
    do not split the rows (`rows`: placements) share them out: ceil(h /
    m) a rank over those m ranks, the last ones short or empty.
    ((first, end, width), the placements of a (B, S, m * width) stack of
    every rank's padded share, and of a (B, m * width, N) one)."""
    over = [j for j, p in enumerate(rows) if p.is_replicate()]
    return (ceil_share(h, *rank_among(mesh, over)),
            [Shard(2) if j in over else p for j, p in enumerate(rows)],
            [Shard(1) if j in over else p for j, p in enumerate(rows)])


def _cb(cmat_c: torch.Tensor, bmat_c: torch.Tensor) -> torch.Tensor:
    """C B^T within each chunk: (B, NC, ch, N) twice -> (B, NC, ch, ch),
    the product every head shares (one B/C group)."""
    return torch.einsum("bcin,bcjn->bcij", cmat_c, bmat_c)


def _cb_shared(mesh, rows):
    """`_cb` with its chunks shared out over the ranks that share the
    channels (the mesh dims `rows` does not split: the ranks of
    `_head_share`), each computing ceil(NC / m) chunks, gathered back in order
    along the chunk axis (an all-gather a mesh dim, innermost first; its
    backward reduce-scatters the gradient), where every such rank would
    repeat the whole product.  The reference's partitioner splits it so.
    A chunk count the m ranks do not divide is shared ceil(NC / m) a
    rank, the last ranks short (padded) or empty."""
    from torch.distributed import _functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single_autograd", None) or \
        funcol.all_gather_tensor_autograd
    over = [j for j, p in enumerate(rows)
            if p.is_replicate() and mesh.size(j) > 1]
    r, m = rank_among(mesh, over)

    def cb(cmat_c, bmat_c):
        nc = cmat_c.shape[1]
        if m == 1:
            return _cb(cmat_c, bmat_c)
        lo, hi, k = ceil_share(nc, r, m)
        part = _cb(cmat_c[:, lo:hi], bmat_c[:, lo:hi]).transpose(0, 1)
        if hi - lo < k:
            part = F.pad(part, (0, 0, 0, 0, 0, 0, 0, k - (hi - lo)))
        for j in reversed(over):        # chunks first: gathered along dim 0
            part = gather(part.contiguous(), 0, (mesh, j))
        return part[:nc].transpose(0, 1)
    return cb


def _gate(y, zxbcdt, norm_w, cfg: ModelConfig, dtype):
    """The gated RMSNorm of the SSD's y (B, S, d_inner) float32 with z, the
    in-projection's first d_inner features, in `dtype` (the out
    projection follows)."""
    d_inner = _dims(cfg)[0]
    y = y.to(dtype)
    return rms_norm(y * F.silu(zxbcdt[..., :d_inner]), norm_w, cfg.norm_eps)


def _gate_share(y, zx, norm_w, cfg: ModelConfig, dtype, rows, chans):
    """`_gate` on each rank's share of the channels: y (B, S, m * width)
    float32 and the z share of zx (`_share_zx`), both laid out as
    `_head_share`'s channel stack.  Each rank forms y · silu(z) in
    `dtype` on its channels and its float32 sum of squares; the sums are
    added over the ranks that share the channels (an all-reduce of (B,
    S, 1); a short share's padding, zero in y and z, adds nothing), and
    each share is scaled by rsqrt(sum / d_inner + eps) and (1 + norm_w)
    on its channels.  The reference's values, but for the order of the
    sum of squares.  Returns the normalised share in `dtype`, laid out
    as y."""
    d_inner = _dims(cfg)[0]
    first, end, width = chans
    mesh = y.device_mesh
    f32 = torch.float32
    g = on_local(lambda t, z: t.to(dtype) * F.silu(z[..., :width]), y, zx,
                 split=(0, 2))
    ss = on_local(lambda t: torch.sum(torch.square(t.to(f32)), dim=-1,
                                      keepdim=True), g, split=(0, 2),
                  place=[Partial() if p.is_replicate() else p for p in rows])
    ss = lay_out(ss, mesh, rows)

    def scale(t, ss, w):
        w = F.pad(1.0 + w[first:end].to(f32), (0, width - (end - first)))
        return (t.to(f32) * torch.rsqrt(ss / d_inner + cfg.norm_eps)
                * w).to(dtype)
    return on_local(scale, g, ss, replicated(norm_w, mesh), split=(0, 2))


def _forward_core(xs, bc, dt, conv_w, dt_bias, a_log, d_skip,
                  cfg: ModelConfig, chans, cb=_cb):
    """The SSD of plain tensors for channels [first, end) of the H * P
    (head-major) of `chans` = (first, end, width), from the
    in-projection's parts: xs (B, S, >= (h1 - h0) P), the x channels of
    the heads [h0, h1) those channels touch (columns past them are
    padding), bc (B, S, 2N) B and C, dt (B, S, H) every head's; conv_w
    (K, d_inner + 2N) whole.  Returns (y (B, S, width) float32 with the
    skip term, the last state (B, width, N)), channels past `end` zero.
    The conv runs on the heads' x channels with B and C, the intra-chunk
    product on the heads (its decay is a head's), the inter-chunk
    products and the state on the channels alone.  All channels (0, H P,
    H P) is the reference's SSD op for op.  `cb` computes the heads'
    shared C B^T (`_cb`, or its chunks shared over ranks:
    `_cb_shared`)."""
    b, s, _ = xs.shape
    d_inner, h, p, n = _dims(cfg)
    first, end, width = chans
    h0, h1 = first // p, -(-end // p)           # the heads touched
    lo, hi = first - h0 * p, end - h0 * p       # their channels kept
    f32 = torch.float32
    conv_in = torch.cat([xs[..., :(h1 - h0) * p], bc], dim=-1)
    if (h0, h1) != (0, h):
        conv_w = torch.cat([conv_w[:, h0 * p:h1 * p], conv_w[:, d_inner:]],
                           dim=-1)
    conv_out = _causal_conv(conv_in, conv_w)
    del conv_in
    xs, bmat, cmat = torch.split(conv_out, [(h1 - h0) * p, n, n], dim=-1)
    xh = xs.reshape(b, s, h1 - h0, p)
    h = h1 - h0
    dt = F.softplus(dt[..., h0:h1].to(f32)
                    + dt_bias[h0:h1])                          # (B, S, H)
    a = -torch.exp(a_log[h0:h1])                               # (H,)
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

    def kept(t):                # (..., H) a head -> (..., C) a channel
        return t.repeat_interleave(p, dim=-1)[..., lo:hi]

    # ---- intra-chunk (quadratic / 'attention' mode) ----
    # L[i, j] = exp(cum_i - cum_j) for i >= j, masked before the exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,NC,i,j,H)
    mask = torch.ones((ch, ch), dtype=torch.bool,
                      device=xs.device).tril()
    decay = torch.exp(torch.where(mask[:, :, None], diff, -math.inf))
    cb = cb(cmat_c, bmat_c)                                   # (B,NC,i,j)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay,
                           xbar).reshape(b, nc, ch, h * p)[..., lo:hi]

    # ---- inter-chunk states, a channel each ----
    # state_c = sum_j exp(total - cum_j) * B_j^T xbar_j
    xbar = xbar.reshape(b, nc, ch, h * p)[..., lo:hi]
    w_in = kept(torch.exp(total[:, :, None, :] - cum))         # (B,NC,ch,C)
    state_c = torch.einsum("bcjn,bcjk->bckn", bmat_c,
                           xbar * w_in)                        # (B,NC,C,N)
    state = torch.zeros((b, hi - lo, n), dtype=f32, device=xs.device)
    step = kept(torch.exp(total))                              # (B,NC,C)
    in_states = []
    for c in range(nc):
        in_states.append(state)                        # incoming state
        state = state * step[:, c, :, None] + state_c[:, c]
    in_states = torch.stack(in_states, dim=1)                  # (B,NC,C,N)

    # ---- inter-chunk contribution: C_i exp(cum_i) state_in ----
    y_inter = torch.einsum("bcin,bckn->bcik", cmat_c, in_states) \
        * kept(torch.exp(cum))

    y = (y_intra + y_inter).reshape(b, s, hi - lo)
    y = y + kept(d_skip[h0:h1]) * xh.reshape(b, s, h * p)[..., lo:hi].to(f32)
    if hi - lo < width:             # a rank's short share of the channels
        y = F.pad(y, (0, width - (hi - lo)))
        state = F.pad(state, (0, 0, 0, width - (hi - lo)))
    return y, state


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
    in-projection's features are shared out over the mesh dims that
    split neither the rows nor the weight (`_columns_apart`), the state,
    its conv history and the projection are laid out by the state's
    batch split (a cache laid out otherwise is written back after), and
    the recurrence runs on local tensors - the state's update on every
    rank that holds it, each rank's share of the channels read out
    (`_head_share` over the state's whole dims: mamba2's 1536 channels
    on 16 or 256 ranks) and gathered."""
    state, conv = cache["state"], cache["conv"]
    weights = [params[k] for k in ("conv_w", "dt_bias", "a_log", "d_skip")]
    d_inner = _dims(cfg)[0]
    if is_dtensor(state):
        mesh = state.device_mesh
        rows = [p if p.is_shard(0) else Replicate() for p in state.placements]
        zx = lay_out(_columns_apart(x_t, params["in_proj"]), mesh, rows)
        chans, by_chan, _ = _head_share(mesh, rows, d_inner)
        st, cv = (lay_out(t, mesh, rows) for t in (state, conv))
        y = on_local(functools.partial(_decode_core, chans=chans), st, cv,
                     zx, *(whole(w) for w in weights), cfg, split=(0,),
                     place=by_chan)
        y = on_local(lambda t: t[..., :d_inner], lay_out(y, mesh, rows),
                     split=(0,))
        for dst, src in ((state, st), (conv, cv)):
            if src is not dst:      # a cache laid out otherwise
                dst.copy_(src)
    else:
        zx = mm(x_t, params["in_proj"])
        y = _decode_core(state, conv, zx, *weights, cfg)
    y = rms_norm(y.to(x_t.dtype) * F.silu(zx[..., :d_inner]),
                 params["norm_w"], cfg.norm_eps)
    return mm(y, params["out_proj"]), cache


def _columns_apart(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for DTensors, w's output features shared out (ceil(N / m) a
    rank, the last short and padded) over the m ranks of the mesh dims
    that split neither x nor w, and the product gathered back whole
    there: mamba2's in-projection of 3352 features, whole on a 16-wide
    "model" axis, is not repeated on every rank of it (a decode step's
    one token leaves no sequence to split, `_rows_apart`)."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return mm(x, w)
    mesh, n = x.device_mesh, w.shape[1]
    x = lay_out(x, mesh, [Replicate() if p.is_partial() else p
                          for p in x.placements])
    over = [j for j, (p, q) in enumerate(zip(x.placements, w.placements))
            if p.is_replicate() and q.is_replicate() and mesh.size(j) > 1]
    if not over:
        return mm(x, w)
    (first, end, width), _, _ = _head_share(mesh, [
        Replicate() if j in over else Shard(0) for j in range(mesh.ndim)], n)

    def share(wl):
        return F.pad(wl[:, first:end], (0, width - (end - first)))
    cols = on_local(share, w, split=(0, 1), place=[
        Shard(1) if j in over else q for j, q in enumerate(w.placements)])
    out = mm(x, cols)
    out = lay_out(out, mesh, [Replicate() if j in over else p
                              for j, p in enumerate(out.placements)])
    return on_local(lambda t: t[..., :n], out, split=range(out.dim() - 1))


def _decode_core(state, conv, zx, conv_w, dt_bias, a_log, d_skip,
                 cfg: ModelConfig, chans=None) -> torch.Tensor:
    """The decode recurrence of plain tensors from the in-projection zx
    (B, 1, F): the conv history and the state updated in place; returns
    y (B, 1, d_inner) in float32 before the gated norm, or, for `chans`
    = (first, end, width), its channels [first, end) padded to width."""
    b = zx.shape[0]
    d_inner, h, p, n = _dims(cfg)
    f32 = torch.float32
    _, xs, bc, dt = torch.split(zx, [d_inner, d_inner, 2 * n, h], dim=-1)
    hist = torch.cat([conv, torch.cat([xs, bc], dim=-1)], dim=1)
    conv_out = F.silu(torch.sum(hist * conv_w[None], dim=1, keepdim=True))
    xs, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)
    xh = xs.reshape(b, h, p)
    dt_t = F.softplus(dt[:, 0].to(f32) + dt_bias)             # (B, H)
    decay = torch.exp(dt_t * -torch.exp(a_log))                # (B, H)
    xbar = xh.to(f32) * dt_t[..., None]
    upd = torch.einsum("bn,bhp->bhpn", bmat[:, 0].to(f32), xbar)
    new_state = state * decay[:, :, None, None] + upd
    state.copy_(new_state)
    conv.copy_(hist[:, 1:, :])
    if chans is None:
        y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].to(f32), new_state)
        y = y + d_skip[:, None] * xh.to(f32)
        return y.reshape(b, 1, d_inner)
    first, end, width = chans
    y = torch.einsum("bn,bcn->bc", cmat[:, 0].to(f32),
                     new_state.reshape(b, h * p, n)[:, first:end])
    y = y + (d_skip.repeat_interleave(p)[first:end]
             * xh.reshape(b, h * p)[:, first:end].to(f32))
    return F.pad(y, (0, width - (end - first)))[:, None]
