"""Prefill traffic: a closed loop of one client sending single prompts,
each through the program's `make_prefill_step` (the whole prefill: the
last position's logits, the greedy next token and the decode-ready KV
cache), the next request sent once the previous one's token id is on the
host.

The traffic file gives `lengths`, a block of prompt lengths with their
counts: requests come in blocks of that mix, each block in an order
drawn from the seed, so every window holds the same mix whatever the
seed.  Request i's token ids are drawn on the device from the seed and
i, before the request starts.  `sample` requests, drawn from the seed
among the first `sample_among` (the longest among those always in), keep
their token and cache for the output check; a sampled request that the
window did not reach runs after it, through the same call.

Set-up draws the weights (`core.make_weights`) and warms up one prefill
at each length of the block, the only shapes the window sends.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from core import make_weights, program_params, sub_seed

PROMPT_TAG, ORDER_TAG, SAMPLE_TAG = 3, 4, 5


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.block = [ctx.clip(n) for n, count in t["lengths"]
                      for _ in range(count)]
        self.lengths: List[int] = []
        rng = np.random.default_rng(sub_seed(ctx.seed, SAMPLE_TAG))
        first = [self.length(i) for i in range(t["sample_among"])]
        longest = int(rng.choice([i for i, n in enumerate(first)
                                  if n == max(first)]))
        others = [i for i in range(t["sample_among"]) if i != longest]
        self.sample = {longest, *rng.choice(others, t["sample"] - 1,
                                            replace=False).tolist()}
        self.kept: Dict[int, tuple] = {}

    def length(self, i: int) -> int:
        while len(self.lengths) <= i:
            b = len(self.lengths) // len(self.block)
            order = np.random.default_rng(
                sub_seed(self.ctx.seed, ORDER_TAG, b)).permutation(
                len(self.block))
            self.lengths.extend(self.block[j] for j in order)
        return self.lengths[i]

    def prompt(self, i: int) -> torch.Tensor:
        gen = torch.Generator(device=self.ctx.device).manual_seed(
            sub_seed(self.ctx.seed, PROMPT_TAG, i))
        return torch.randint(0, self.ctx.shapes["vocab"], (1, self.length(i)),
                             generator=gen, device=self.ctx.device)

    def setup(self):
        from repro_torch.models.serve_step import make_prefill_step
        ctx = self.ctx
        self.params = program_params(make_weights(ctx.shapes, ctx.seed,
                                                  ctx.device, ctx.dtype))
        self.step = make_prefill_step(ctx.model_cfg)
        with torch.no_grad():
            for n in sorted(set(self.block)):
                ids = torch.zeros((1, n), dtype=torch.long, device=ctx.device)
                tok, cache = self.step(self.params, {"tokens": ids})
                int(tok[0])
                del cache

    def request(self, i: int, span):
        prompt = self.prompt(i)
        with span("bench.request"):
            start = time.perf_counter()
            tok, cache = self.step(self.params, {"tokens": prompt})
            token = int(tok[0])         # the first token id on the host
            end = time.perf_counter()
        if i in self.sample:
            self.kept[i] = (token, cache)
        return {"tokens": prompt.shape[1], "start": start, "end": end,
                "seq_len": prompt.shape[1], "rows": 1}

    def window(self, seconds: float, span) -> List[dict]:
        items = []
        t0 = time.perf_counter()
        with torch.no_grad():
            while True:
                items.append(self.request(len(items), span))
                if items[-1]["end"] - t0 >= seconds:
                    break
        return items

    def release(self):
        """Answer the sampled requests the window did not reach, then drop
        the program's weights before the reference runs."""
        with torch.no_grad():
            for i in sorted(self.sample - set(self.kept)):
                self.request(i, lambda name: contextlib.nullcontext())
        del self.params, self.step
        gc.collect()
        if self.ctx.on_card:
            torch.cuda.empty_cache()

    def reference_models(self, *quants):
        """The plain reference over the seed's weights drawn again, one
        model a precision (None: float32)."""
        from reference import lm
        lm.exact_float32()
        w = make_weights(self.ctx.shapes, self.ctx.seed, self.ctx.device,
                         self.ctx.dtype)
        return [lm.Model(w, self.ctx.shapes, q) for q in quants]

    def check(self) -> Dict[str, float]:
        self.release()
        return self.compare()

    def compare(self) -> Dict[str, float]:
        """The numbers the output check compares, over the sampled
        requests' kept answers: the widest relative gap (Frobenius) of a
        layer's cached keys or values against the reference's, and the
        widest gap by which the served token's logit lies below the
        reference's best at the last position."""
        model, = self.reference_models(None)
        cache_err, token_gap = 0.0, 0.0
        for i in sorted(self.kept):
            token, cache = self.kept.pop(i)
            layers = cache["blocks"]["b0"]
            n = self.length(i)

            def on_layer(j, k, v):
                nonlocal cache_err
                for got, want in ((layers["k"][j, 0, :n], k),
                                  (layers["v"][j, 0, :n], v)):
                    err = float((got.float() - want).norm() / want.norm())
                    cache_err = max(cache_err, err)

            with torch.no_grad():
                hidden = model.prefill(self.prompt(i)[0], on_layer)
                logits = model.logits(hidden[-1:])[0]
            token_gap = max(token_gap, float(logits.max() - logits[token]))
            del cache, layers, hidden, logits
        return {"cache_rel_err": cache_err, "token_gap": token_gap}

    def control(self) -> Dict[str, Dict]:
        """The numbers of the control: the reference computed in float8
        (`quant="fp8"`) answers the sampled requests in the program's place
        - its greedy token at the last position and its cache - and they
        are compared as the program's are."""
        low, = self.reference_models("fp8")
        for i in sorted(self.sample):
            ks, vs = [], []
            with torch.no_grad():
                hidden = low.prefill(self.prompt(i)[0], lambda j, k, v: (
                    ks.append(k), vs.append(v)))
                token = int(low.logits(hidden[-1:])[0].argmax())
            del hidden
            self.kept[i] = (token, {"blocks": {"b0": {
                "k": torch.stack(ks)[:, None], "v": torch.stack(vs)[:, None]}}})
            del ks, vs
        del low
        return {"control": self.compare(), "faults": {}}
