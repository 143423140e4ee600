"""The plain reference of the dense decoder the cells run: plain PyTorch
in float32, written from the architecture and not from the program (it
imports nothing of `repro_torch`).

The architecture, as the configuration files state it: token embedding;
per layer, x + attn(norm(x)) then x + swiglu(norm(x)); a final norm and an
untied head.  norm(x) = x / sqrt(mean(x^2) + eps) * (1 + w).  Attention is
causal, grouped-query (query head h reads key/value head h // (H / KV)),
scaled by head_dim^-1/2, with rotary embedding on the whole head: the
pairs (i, i + hd/2) rotated by position * theta^(-i / (hd/2)).
swiglu(x) = (silu(x Wg) * (x Wu)) Wd.  Training's loss is the mean next-
token cross entropy over the batch's tokens, its optimiser AdamW
(b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1 on the weight matrices) at
3e-4 times a linear warm-up of 200 steps, with the parameters kept in
their stored type (bfloat16) and the moments in float32.

Every product runs in float32 with TF32 off, unless `quant="fp8"`: then
both operands of every product (projections, scores, p . v, the head)
are rounded to float8 e4m3 with one scale a tensor first - the benchmark's
control, the step below the bfloat16 the configurations state.  The work
is split into blocks of rows and heads so that it fits the card beside
nothing else.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
FP8_MAX = 448.0


def exact_float32() -> None:
    """float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (amax / 448), as float32;
    the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return x + (q - x).detach() if x.requires_grad else q


def _operands(quant: Optional[str], *xs):
    if quant is None:
        return xs
    if quant != "fp8":
        raise ValueError(f"unknown quant {quant!r}")
    return tuple(_fp8(x) for x in xs)


def matmul(a, b, quant=None):
    a, b = _operands(quant, a, b)
    return a @ b


def norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


def rotate(x, positions, theta):
    """Rotary embedding of x (S, heads, hd) at `positions` (S,)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[:, None] * inv[None, :]
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def causal_attention(q, k, v, quant=None, q_block=4096, head_block=8):
    """softmax(q k^T / sqrt(hd), causal) v for q (S, H, hd) and k, v
    (S, KV, hd), in blocks of queries and heads; each query block reads the
    keys up to its own last position.  Returns (S, H * hd)."""
    s, h, hd = q.shape
    group = h // k.shape[1]
    out = q.new_empty((s, h, hd))
    scale = hd ** -0.5
    for h0 in range(0, h, head_block):
        h1 = min(h0 + head_block, h)
        kv = torch.arange(h0, h1, device=q.device) // group
        kh = k[:, kv].transpose(0, 1)           # (hb, S, hd)
        vh = v[:, kv].transpose(0, 1)
        for a in range(0, s, q_block):
            b = min(a + q_block, s)
            qb = q[a:b, h0:h1].transpose(0, 1)  # (hb, qb, hd)
            scores = matmul(qb, kh[:, :b].transpose(1, 2), quant) * scale
            keep = (torch.arange(a, b, device=q.device)[:, None]
                    >= torch.arange(b, device=q.device)[None, :])
            p = torch.softmax(scores.masked_fill(~keep, -math.inf), dim=-1)
            del scores
            out[a:b, h0:h1] = matmul(p, vh[:, :b], quant).transpose(0, 1)
            del p
    return out.reshape(s, h * hd)


def _attention_grad(q, k, v, quant):
    """The whole (S, S) causal attention of one sequence, differentiable
    (training's sequences are short enough to hold it)."""
    s, h, hd = q.shape
    group = h // k.shape[1]
    k, v = (t.repeat_interleave(group, dim=1).transpose(0, 1) for t in (k, v))
    scores = matmul(q.transpose(0, 1), k.transpose(1, 2), quant) * hd ** -0.5
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~keep, -math.inf), dim=-1)
    return matmul(p, v, quant).transpose(0, 1).reshape(s, h * hd)


class Model:
    """The decoder over weights in the benchmark's layout (`bench/core.py`
    `weight_layout`), computing in float32 whatever type they are stored
    in (a matrix is converted where it is used)."""

    def __init__(self, weights: Dict, sh: dict, quant: Optional[str] = None):
        self.w, self.sh, self.quant = weights, sh, quant

    def _w(self, name, layer=None):
        t = self.w[name] if layer is None else self.w[name][layer]
        return t.to(F32)

    def layer_kv(self, i, h, positions):
        """(k, v) of layer i for its normed input h (S, d): k rotated."""
        sh = self.sh
        k = matmul(h, self._w("wk", i), self.quant).view(
            h.shape[0], sh["kv_heads"], sh["head_dim"])
        v = matmul(h, self._w("wv", i), self.quant).view(
            h.shape[0], sh["kv_heads"], sh["head_dim"])
        return rotate(k, positions, sh["rope_theta"]), v

    def ffn(self, i, x, rows=8192):
        """x + swiglu(norm(x)) for x (S, d), in blocks of rows."""
        out = torch.empty_like(x)
        for a in range(0, x.shape[0], rows):
            xb = x[a:a + rows]
            h = norm(xb, self._w("ln2", i), self.sh["norm_eps"])
            g = F.silu(matmul(h, self._w("gate", i), self.quant))
            g = g * matmul(h, self._w("up", i), self.quant)
            out[a:a + rows] = xb + matmul(g, self._w("down", i), self.quant)
        return out

    def prefill(self, tokens: torch.Tensor, on_layer=None):
        """The final hidden states (S, d), normed, of one prompt (S,);
        `on_layer(i, k, v)` sees each layer's rotated keys and values."""
        sh = self.sh
        s = tokens.shape[0]
        pos = torch.arange(s, device=tokens.device)
        x = self.w["embed"][tokens].to(F32)
        for i in range(sh["n_layers"]):
            h = norm(x, self._w("ln1", i), sh["norm_eps"])
            q = matmul(h, self._w("wq", i), self.quant).view(
                s, sh["n_heads"], sh["head_dim"])
            q = rotate(q, pos, sh["rope_theta"])
            k, v = self.layer_kv(i, h, pos)
            del h
            if on_layer is not None:
                on_layer(i, k, v)
            a = causal_attention(q, k, v, self.quant)
            del q, k, v
            x = x + matmul(a, self._w("wo", i), self.quant)
            del a
            x = self.ffn(i, x)
        return norm(x, self.w["ln_f"].to(F32), sh["norm_eps"])

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return matmul(hidden, self._w("head"), self.quant)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

B1, B2, EPS, WD, LR, WARMUP = 0.9, 0.95, 1e-8, 0.1, 3e-4, 200
MATRICES = ("embed", "head", "wq", "wk", "wv", "wo", "gate", "up", "down")


def lr_at(step: int) -> float:
    """The learning rate of step `step` (0-based) in the warm-up."""
    return LR * (step + 1) / WARMUP


def _layer_grad(x, ln1, wq, wk, wv, wo, ln2, gate, up, down, sh, quant):
    s = x.shape[0]
    pos = torch.arange(s, device=x.device)
    hd, eps, theta = sh["head_dim"], sh["norm_eps"], sh["rope_theta"]
    h = norm(x, ln1, eps)
    q = rotate(matmul(h, wq, quant).view(s, -1, hd), pos, theta)
    k = rotate(matmul(h, wk, quant).view(s, -1, hd), pos, theta)
    v = matmul(h, wv, quant).view(s, -1, hd)
    x = x + matmul(_attention_grad(q, k, v, quant), wo, quant)
    h = norm(x, ln2, eps)
    g = F.silu(matmul(h, gate, quant)) * matmul(h, up, quant)
    return x + matmul(g, down, quant)


def sequence_loss(p: Dict, tokens, labels, sh, quant=None):
    """Summed next-token cross entropy of one sequence; each layer is
    recomputed in the backward (only its input is kept)."""
    x = p["embed"][tokens]
    for i in range(sh["n_layers"]):
        x = checkpoint(_layer_grad, x, p["ln1"][i], p["wq"][i], p["wk"][i],
                       p["wv"][i], p["wo"][i], p["ln2"][i], p["gate"][i],
                       p["up"][i], p["down"][i], sh, quant,
                       use_reentrant=False)
    logits = matmul(norm(x, p["ln_f"], sh["norm_eps"]), p["head"], quant)
    return F.cross_entropy(logits, labels, reduction="sum")


def train(weights: Dict, sh: dict, batches: Iterable[Dict], n_micro: int,
          quant: Optional[str] = None, keep_rows: Optional[int] = None):
    """Follows AdamW steps of the loss over `batches` (each {"tokens",
    "labels"} of (B, S)) from `weights`, in `n_micro` microbatches of
    consecutive rows.  Returns {"loss": [each step's mean loss],
    "grad": {leaf: norm of step 1's gradient}, "change": {leaf: norm of
    the parameters' change over the steps}, "m", "v": {leaf: norm of
    AdamW's moment after the steps}}.  `keep_rows` takes the loss
    over the first rows of each batch alone (the fault of a step that
    leaves half its batch out)."""
    params = {k: t.clone() for k, t in weights.items()}
    m = {k: torch.zeros_like(t, dtype=F32) for k, t in params.items()}
    vv = {k: torch.zeros_like(t, dtype=F32) for k, t in params.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for step, batch in enumerate(batches):
        tokens, labels = batch["tokens"], batch["labels"]
        if keep_rows is not None:
            tokens, labels = tokens[:keep_rows], labels[:keep_rows]
        p32 = {k: t.to(F32).requires_grad_() for k, t in params.items()}
        grads = {k: torch.zeros_like(t) for k, t in p32.items()}
        loss = 0.0
        rows = tokens.shape[0]
        per = rows // n_micro if keep_rows is None else rows
        for a in range(0, rows, per):
            micro = 0.0
            for r in range(a, a + per):
                micro = micro + sequence_loss(p32, tokens[r], labels[r], sh,
                                              quant)
            micro = micro / (per * tokens.shape[1])
            g = torch.autograd.grad(micro, list(p32.values()))
            for key, gk in zip(p32, g):
                grads[key].add_(gk, alpha=per / rows)
            loss += float(micro.detach()) * per / rows
        losses.append(loss)
        if step == 0:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
        del p32
        lr = lr_at(step)
        bc1, bc2 = 1 - B1 ** (step + 1), 1 - B2 ** (step + 1)
        with torch.no_grad():
            for key, g in grads.items():
                m[key].mul_(B1).add_(g, alpha=1 - B1)
                vv[key].mul_(B2).addcmul_(g, g, value=1 - B2)
                delta = (m[key] / bc1) / ((vv[key] / bc2).sqrt() + EPS)
                p = params[key].to(F32)
                if key in MATRICES:
                    delta = delta + WD * p
                params[key] = (p - lr * delta).to(params[key].dtype)
        del grads
    change = {k: float((params[k].to(F32) - weights[k].to(F32)).norm())
              for k in params}
    return {"loss": losses, "grad": grad_norms, "change": change,
            "m": {k: float(t.norm()) for k, t in m.items()},
            "v": {k: float(t.norm()) for k, t in vv.items()}}
