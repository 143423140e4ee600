"""Batched LM generation engine, as `repro/models/lm_engine.py`: prefill
once, then decode step by step - the reference's `lax.scan` over decode
steps is a host loop here, which queues every step on the card without
reading anything back until the end."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.serve_step import make_decode_step, make_prefill_step
from repro_torch.sharding.api import whole


@dataclasses.dataclass
class Engine:
    cfg: ModelConfig
    params: Dict
    max_len: int = 512
    temperature: float = 0.0
    eos_id: Optional[int] = None

    def __post_init__(self):
        self._prefill = make_prefill_step(self.cfg, self.max_len)
        self._decode = make_decode_step(self.cfg, self.temperature)

    def generate(self, tokens: torch.Tensor, n_steps: int,
                 gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens: (B, S_prompt) -> (B, n_steps) generated ids (int32).

        `gen` drives sampling (temperature > 0); by default a generator
        seeded 0 on the parameters' device.  As in the reference, the
        first id is the prefill's, each later one a decode step's; a
        sequence that produced `eos_id` repeats it from then on.  Under a
        sharding policy the ids come back whole on every rank.
        """
        b, s = tokens.shape
        assert s + n_steps <= self.max_len
        dev = self.params["embed"].device
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(0)
        tok, cache = self._prefill(self.params, {"tokens": tokens})
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        out = []
        for step in range(n_steps):
            out.append(tok)
            new_tok, cache = self._decode(self.params, cache, tok, s + step,
                                          gen)
            if self.eos_id is not None:
                done = torch.logical_or(done, new_tok == self.eos_id)
                new_tok = torch.where(done, self.eos_id, new_tok).to(
                    torch.int32)
            tok = new_tok
        return whole(torch.stack(out, dim=1))       # (B, n_steps)
