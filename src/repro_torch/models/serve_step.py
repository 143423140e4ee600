"""Serving steps, as `repro/models/serve_step.py`: prefill of a prompt
batch and one decode step against a cache.  PyTorch runs them eagerly;
there is nothing to jit.  Greedy picks go through `sharding.api.argmax`,
which takes logits split over the vocabulary on each rank's shard."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tr
from repro_torch.sharding.api import argmax


def make_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None):
    """prefill(params, tokens|embeds) -> (next_token, cache)."""

    def prefill_step(params, batch: Dict):
        with tracing.span("serve.prefill"):
            logits, cache = tr.prefill(
                params, cfg, tokens=batch.get("tokens"),
                embeds=batch.get("embeds"), cache_len=cache_len)
            next_tok = argmax(logits).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, temperature: float = 0.0):
    """decode(params, cache, token, pos, gen) -> (token, cache).

    Greedy at temperature 0; above it, a draw from softmax(logits / T)
    with the caller's `torch.Generator` (on the logits' device), which
    cannot replay the reference's `jax.random.categorical` bits.
    """

    def decode_step(params, cache, tokens_t, pos, gen):
        logits, cache = tr.decode_step(params, cache, tokens_t, pos, cfg)
        if temperature > 0.0:
            probs = torch.softmax(logits.to(torch.float32) / temperature,
                                  dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = argmax(logits)
        return nxt.to(torch.int32), cache

    return decode_step
