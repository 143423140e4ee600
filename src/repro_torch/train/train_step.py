"""Training step: loss, gradients, microbatch accumulation, optimizer
update, as `repro/train/train_step.py`.

The step is eager - no `torch.compile`, which would hide what the step
costs - and runs on the device of the parameters.  Gradients come from
`torch.autograd.grad` on detached, grad-requiring aliases of the
parameters (no copies), so the caller's tensors never require grad.
Microbatching (gradient accumulation) runs `global_batch // microbatch`
forward-backward passes over consecutive slices of the batch, adding
`g / n_micro` to a buffer in `accum_dtype`, as the reference's scan.

On a mesh the state's leaves are DTensors (`sharding/partition.py`'s
`make_state_shardings` + `distribute`) and the step runs inside the
policy's scope: the model's annotations lay activations out, DTensor
inserts the gradient reductions.  `grad_shardings` (a tree of
`NamedSharding`s like the parameters, from `make_param_shardings`) lays
each gradient, the microbatch accumulator included, out as its leaf, as
the reference's `constrain` does: the batch-axis reduction becomes a
reduce-scatter into the parameter's shards.  The metrics come back as
plain 0-d tensors, whole on every rank.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import transformer as tr
from repro_torch.numerics import over
from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.sharding.api import (is_dtensor, lay_out, mesh_ops,
                                      replicated, whole)
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
    reference's one-hot reduce exactly.  Logits split over the vocabulary
    (a DTensor) take that reduce itself, which stays split."""
    logits, aux = tr.forward(params, model_cfg, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"), remat=remat)
    labels = batch["labels"]                        # (B, S) int, -1 = pad
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    target = labels.clamp(min=0).long()[..., None]
    if is_dtensor(logits):      # vocab-split logits: the one-hot reduce
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        ll = torch.sum(torch.where(vocab == target, logits, 0.0), dim=-1)
    else:
        ll = torch.gather(logits, -1, target)[..., 0]
    mask = (labels >= 0).to(torch.float32)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    ce = torch.sum((lse - ll) * mask) / denom
    loss = ce + AUX_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


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
            loss, metrics, grads = grad_fn(state.params, batch)
            return loss, metrics, constrain(grads)
        grads = constrain(tree_map(
            lambda p: torch.zeros_like(p, dtype=acc_dt), state.params))
        dev = next(tree_leaves(state.params)).device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n_micro):
            micro = {key: x[i * (x.shape[0] // n_micro):
                            (i + 1) * (x.shape[0] // n_micro)]
                     for key, x in batch.items()}
            l_i, _, g = grad_fn(state.params, micro)
            g = constrain(g)
            with torch.no_grad():   # g / n_micro in g's dtype, as JAX
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
            lr_scale = warmup_cosine(state.opt.step)
            new_params, new_opt = opt.update(grads, state.opt, state.params,
                                             lr_scale=lr_scale)
            with torch.no_grad():
                gnorm = torch.sqrt(sum(
                    torch.sum(torch.square(g.to(torch.float32)))
                    for g in tree_leaves(grads)))
            metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                           lr_scale=lr_scale)
            metrics = {key: whole(val) for key, val in metrics.items()}
        return TrainState(new_params, new_opt), metrics

    return step
