"""Deterministic synthetic LM data pipeline (host-sharded layout), as
`repro/data/pipeline.py`.

Every batch is a pure function of (seed, step, shard): the same numpy
draws as the reference's (`np.random.default_rng(SeedSequence([seed,
step, shard]))`), so both packages see the same tokens, labels and
embeddings bit for bit.  Tokens follow a Zipf-ish distribution with
short-range structure (copied spans) so models have signal to fit.
Tokens and labels come out as int64 tensors, embeddings (the `vit_stub`
frontend) as float32, on `device` (default the card).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass
class SyntheticLM:
    model_cfg: ModelConfig
    run_cfg: RunConfig
    seed: int = 0
    n_shards: int = 1
    shard: int = 0
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        b = self.run_cfg.global_batch // self.n_shards
        s = self.run_cfg.seq_len
        v = self.model_cfg.vocab
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        # Zipf-ish marginals + copied spans for learnable structure
        base = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64) % v
        span = max(8, s // 64)
        starts = rng.integers(0, s + 1 - 2 * span, size=b)
        for i in range(b):
            st = starts[i]
            base[i, st + span:st + 2 * span] = base[i, st:st + span]
        tokens = torch.from_numpy(base[:, :-1].copy()).to(self.device)
        labels = torch.from_numpy(base[:, 1:].copy()).to(self.device)
        out = {"tokens": tokens, "labels": labels}
        if self.model_cfg.frontend == "vit_stub":
            # Pixtral-style: the stub supplies the fused embedding stream
            emb = rng.standard_normal((b, s, self.model_cfg.d_model),
                                      dtype=np.float32) * 0.02
            out = {"embeds": torch.from_numpy(emb).to(self.device),
                   "labels": labels}
        return out
