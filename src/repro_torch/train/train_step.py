"""Training step: loss, gradients, microbatch accumulation, optimizer
update, as `repro/train/train_step.py`.

The step is eager - no `torch.compile`, which would hide what the step
costs - and runs on the device of the parameters.  Gradients come from
`torch.autograd.grad` on detached, grad-requiring aliases of the
parameters (no copies), so the caller's tensors never require grad.
Microbatching (gradient accumulation) runs `global_batch // microbatch`
forward-backward passes over consecutive slices of the batch, adding
`g / n_micro` to a buffer in `accum_dtype`, as the reference's scan.  A
DTensor batch is laid out once a step as (n_micro, mb, ...) with each
microbatch's rows split as the batch's (`sharding.api.split_rows`: one
all-to-all), so no rank holds a whole microbatch; slicing a split
DTensor would gather it.

On a mesh the state's leaves are DTensors (`sharding/partition.py`'s
`make_state_shardings` + `distribute`) and the step runs inside the
policy's scope: the model's annotations lay activations out, DTensor
inserts the gradient reductions.  `grad_shardings` (a tree of
`NamedSharding`s like the parameters, from `make_param_shardings`) lays
each gradient, the microbatch accumulator included, out as its leaf, as
the reference's `constrain` does: the batch-axis reduction becomes a
reduce-scatter into the parameter's shards.  Vocabulary-split logits
take the loss on each rank's shard (`_split_terms`), never whole.  The
metrics come back as plain 0-d tensors, whole on every rank.  While a
profiler records, each microbatch's forward and backward, its
accumulation and the optimiser's part are spans of `repro_torch.tracing`
(`train.microbatch`, `train.accumulate`, `train.optimizer`).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Partial, Replicate

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import transformer as tr
from repro_torch.numerics import over
from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.sharding.api import (is_dtensor, lay_out, local_box,
                                      mesh_ops, on_local, replicated,
                                      split_rows, take, whole)
from repro_torch.sharding.partition import NamedSharding
from repro_torch.tree import tree_leaves, tree_map

AUX_WEIGHT = 0.01   # MoE load-balance loss weight

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(gen: torch.Generator, model_cfg: ModelConfig,
                     run_cfg: RunConfig, opt: Optional[AdamW] = None
                     ) -> Tuple[TrainState, AdamW]:
    """Parameters drawn from `gen` on its device (`tr.init_params`) and a
    zero optimizer state beside them."""
    if opt is None:
        opt = AdamW(lr=run_cfg.learning_rate,
                    moments_dtype=_DTYPES[run_cfg.moments_dtype])
    params = tr.init_params(gen, model_cfg)
    return TrainState(params=params, opt=opt.init(params)), opt


def loss_fn(params, batch: Dict, model_cfg: ModelConfig,
            remat: str = "none") -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy over the padded vocabulary, masked where
    labels < 0, plus AUX_WEIGHT * aux.  The label logit is gathered: its
    sum over the vocabulary has one nonzero term, so the gather is the
    reference's one-hot reduce exactly.  Logits that are a DTensor take
    both terms on each rank's vocabulary shard (`_split_terms`)."""
    logits, aux = tr.forward(params, model_cfg, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"), remat=remat)
    labels = batch["labels"]                        # (B, S) int, -1 = pad
    logits = logits.to(torch.float32)
    if is_dtensor(logits):
        labels = lay_out(labels, logits.device_mesh, _rows(logits))
        lse, ll = _split_terms(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        target = labels.clamp(min=0).long()[..., None]
        ll = torch.gather(logits, -1, target)[..., 0]
    mask = (labels >= 0).to(torch.float32)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    ce = torch.sum((lse - ll) * mask) / denom
    loss = ce + AUX_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


def _rows(logits) -> list:
    """The placements of a (B, S) tensor laid out as the rows of the
    DTensor `logits` (B, S, V)."""
    return [p if p.is_shard() and p.dim < 2 else Replicate()
            for p in logits.placements]


def _split_terms(logits, labels):
    """(log-sum-exp, label logit) of DTensor logits (B, S, V) at `labels`
    (B, S, laid out as the logits' rows), each reduced on the rank's own
    vocabulary shard (`_ShardTerms`) into a partial sum over the mesh dims
    that split the vocabulary: exp(x - m) summed, and the label logit
    where the label lies in the shard (0 elsewhere); m, the rows' largest
    logit, is a max over those dims (a shift no gradient sees).  No mesh
    dim gathers the vocabulary (DTensor's own logsumexp would), and
    nothing is read back (`local_box`), so it also traces on fake
    tensors.  Where no mesh dim splits the vocabulary, each rank's rows
    take the unsharded formulas, op for op."""
    mesh, rows = logits.device_mesh, _rows(logits)
    vocab = [j for j, p in enumerate(logits.placements)
             if p.is_shard(2) and mesh.size(j) > 1]
    if not vocab:
        return (on_local(lambda t: torch.logsumexp(t, dim=-1), logits,
                         split=(0, 1, 2), place=rows),
                on_local(lambda t, lab: torch.gather(
                    t, -1, lab.clamp(min=0).long()[..., None])[..., 0],
                    logits, labels, split=(0, 1, 2), place=rows))
    size, off = local_box(logits)
    partial = [Partial() if j in vocab else p for j, p in enumerate(rows)]

    def top(t):
        m = t.detach().amax(dim=-1)
        for j in vocab:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(j))
        return m

    def terms(t, m, lab):
        return _ShardTerms.apply(t, m, lab.clamp(min=0).long() - off[2])

    m = on_local(top, logits, split=(0, 1, 2), place=rows)
    both = lay_out(on_local(terms, logits, m, labels, split=(0, 1, 2),
                            place=partial), mesh, rows)
    total, ll = (on_local(lambda t, k=k: t[..., k], both, split=(0, 1))
                 for k in (0, 1))
    return m + torch.log(total), ll


class _ShardTerms(torch.autograd.Function):
    """A vocabulary shard's terms of the cross entropy: t (B, S, v) float32
    logits, m (B, S) the shift, at (B, S) the label's index in the shard
    (out of [0, v) where it lies in another) -> (B, S, 2): the sum of
    exp(t - m) and the label logit (0 where the label is elsewhere).  The
    backward writes the logits' gradient into one buffer, where autograd's
    exp, gather and sum would hold three of the shard's size."""

    @staticmethod
    def forward(ctx, t, m, at):
        v = t.shape[-1]
        hit = (at >= 0) & (at < v)
        idx = at.clamp(0, v - 1)[..., None]
        total = torch.sum(torch.exp(t - m[..., None]), dim=-1)
        ll = torch.where(hit, torch.gather(t, -1, idx)[..., 0], 0.0)
        ctx.save_for_backward(t, m, idx, hit)
        return torch.stack([total, ll], dim=-1)

    @staticmethod
    def backward(ctx, g):
        t, m, idx, hit = ctx.saved_tensors
        grad = torch.exp(t - m[..., None])
        grad.mul_(g[..., :1])
        grad.scatter_add_(-1, idx, torch.where(hit, g[..., 1], 0.0)[..., None])
        return grad, None, None


def value_and_grad(params, batch: Dict, model_cfg: ModelConfig,
                   remat: str = "none"):
    """(loss, metrics, grads) of `loss_fn`, the gradients a tree like
    `params` in the parameters' dtypes (zeros for an unused leaf, as JAX
    gives)."""
    diff = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = list(tree_leaves(diff))
    with torch.enable_grad():
        loss, metrics = loss_fn(diff, batch, model_cfg, remat)
        loss = replicated(loss)     # one seed gradient, not one a rank
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_leaf = {id(p): (torch.zeros_like(p) if g is None else g)
               for p, g in zip(flat, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: by_leaf[id(p)], diff))


def _parts(x: torch.Tensor, n: int) -> torch.Tensor:
    """A batch leaf laid out once a step for its n microbatches: a DTensor
    as (n, B // n, ...) with each microbatch's rows split as the batch's
    (`api.split_rows`), so that no microbatch is gathered; a plain tensor
    as it is."""
    return split_rows(x, n) if is_dtensor(x) else x


def _part(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch i of `_parts`' leaf: rows [i*mb, (i+1)*mb) of the batch,
    the reference's `x.reshape(n, mb, ...)[i]`."""
    if is_dtensor(x):
        return take(x, i)
    mb = x.shape[0] // n
    return x[i * mb:(i + 1) * mb]


def make_train_step(model_cfg: ModelConfig, run_cfg: RunConfig, opt: AdamW,
                    grad_shardings=None):
    """Returns step(state, batch) -> (state, metrics), metrics holding
    loss, ce, aux, grad_norm and lr_scale as device tensors.
    `grad_shardings` lays every gradient out as its parameter (module
    docstring)."""
    if grad_shardings is not None:
        bad = [sh for sh in tree_leaves(grad_shardings)
               if not isinstance(sh, NamedSharding)]
        if bad:
            raise TypeError(f"grad_shardings: a tree of NamedSharding "
                            f"like the parameters, not {bad[0]!r}")
    n_micro = 1
    if run_cfg.microbatch is not None:
        if run_cfg.global_batch % run_cfg.microbatch:
            raise ValueError(f"global_batch {run_cfg.global_batch} is not a "
                             f"multiple of microbatch {run_cfg.microbatch}")
        n_micro = run_cfg.global_batch // run_cfg.microbatch
    acc_dt = _DTYPES[run_cfg.accum_dtype]

    def grad_fn(params, batch):
        return value_and_grad(params, batch, model_cfg, run_cfg.remat)

    def constrain(grads):
        if grad_shardings is None:
            return grads
        return tree_map(lambda g, sh: lay_out(g, sh.mesh, sh.placements),
                        grads, grad_shardings)

    def accumulate(state: TrainState, batch: Dict):
        if n_micro == 1:
            with tracing.span("train.microbatch"):
                loss, metrics, grads = grad_fn(state.params, batch)
            return loss, metrics, constrain(grads)
        grads = constrain(tree_map(
            lambda p: torch.zeros_like(p, dtype=acc_dt), state.params))
        dev = next(tree_leaves(state.params)).device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        parts = {key: _parts(x, n_micro) for key, x in batch.items()}
        for i in range(n_micro):
            micro = {key: _part(x, i, n_micro) for key, x in parts.items()}
            with tracing.span("train.microbatch"):
                l_i, _, g = grad_fn(state.params, micro)
            g = constrain(g)
            # g / n_micro in g's dtype, as JAX
            with tracing.span("train.accumulate"), torch.no_grad():
                for acc, x in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(over(x, n_micro).to(acc_dt))
            del g
            loss = loss + over(l_i, n_micro)
        metrics = {"ce": loss,
                   "aux": torch.zeros((), dtype=torch.float32,
                                      device=loss.device)}
        return loss, metrics, grads

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        sharded = any(is_dtensor(p) for p in tree_leaves(state.params))
        with mesh_ops() if sharded else contextlib.nullcontext():
            loss, metrics, grads = accumulate(state, batch)
            with tracing.span("train.optimizer"):
                lr_scale = warmup_cosine(state.opt.step)
                new_params, new_opt = opt.update(
                    grads, state.opt, state.params, lr_scale=lr_scale)
                with torch.no_grad():
                    gnorm = torch.sqrt(sum(
                        torch.sum(torch.square(g.to(torch.float32)))
                        for g in tree_leaves(grads)))
            metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                           lr_scale=lr_scale)
            metrics = {key: whole(val) for key, val in metrics.items()}
        return TrainState(new_params, new_opt), metrics

    return step
