"""LM continuous batching, as `repro/models/lm_scheduler.py`: slot-level
request scheduling over a shared cache.

When one sequence finishes, the next queued request takes its slot at
once; prompts stream through the same per-token decode step
(teacher-forced) while neighbouring slots keep generating.  Each slot runs
at its own position (`attention_decode` takes per-slot positions) and an
admitted slot's cache is zeroed (`reset_slots`).  The host does the slot
bookkeeping, line for line as the reference; each step reads the batch's
next tokens back once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tr


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new: int


def reset_slots(cache, mask: torch.Tensor, _stacked: bool = False):
    """Zero the cache state of slots where mask[b] is True, in place
    (the batch axis is 1 under "blocks", 0 elsewhere); returns `cache`."""
    for key, leaf in cache.items():
        stacked = _stacked or key == "blocks"
        if isinstance(leaf, dict):
            reset_slots(leaf, mask, stacked)
            continue
        ax = 1 if stacked else 0
        shape = [1] * leaf.dim()
        shape[ax] = mask.shape[0]
        leaf.masked_fill_(mask.to(leaf.device).reshape(shape), 0)
    return cache


class ContinuousBatchingEngine:
    """Greedy continuous-batching server with `n_slots` parallel lanes, on
    the parameters' device.  Each `run` starts from a zeroed float32 cache,
    as the reference's; decode and `reset_slots` update it in place (the
    reference donates it to its step)."""

    def __init__(self, cfg: ModelConfig, params, n_slots: int,
                 max_len: int, eos_id: Optional[int] = None):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = params["embed"].device

    def _step(self, cache, tokens_t, pos):
        logits, cache = tr.decode_step(self.params, cache, tokens_t, pos,
                                       self.cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve all requests to completion; returns generated ids per req."""
        queue = list(requests)
        out: Dict[int, List[int]] = {r.req_id: [] for r in requests}
        # host-side slot state
        slot_req: List[Optional[Request]] = [None] * self.n_slots
        pos = np.zeros(self.n_slots, np.int32)
        cur = np.zeros(self.n_slots, np.int32)
        n_gen = np.zeros(self.n_slots, np.int32)
        cache = tr.init_cache(self.n_slots, self.max_len, self.cfg,
                              dtype=torch.float32, device=self.device)

        def admit(s):
            nonlocal cache
            if not queue:
                slot_req[s] = None
                return False
            req = queue.pop(0)
            slot_req[s] = req
            pos[s] = 0
            cur[s] = req.prompt[0]
            n_gen[s] = 0
            mask = torch.from_numpy(np.arange(self.n_slots) == s)
            cache = reset_slots(cache, mask)
            return True

        for s in range(self.n_slots):
            admit(s)

        while any(r is not None for r in slot_req):
            nxt, cache = self._step(cache,
                                    torch.from_numpy(cur).to(self.device),
                                    torch.from_numpy(pos).to(self.device))
            nxt = nxt.cpu().numpy()
            for s, req in enumerate(slot_req):
                if req is None:
                    continue
                in_prompt = pos[s] + 1 < len(req.prompt)
                if in_prompt:                      # stream the prompt
                    cur[s] = req.prompt[pos[s] + 1]
                else:                              # generating
                    tok = int(nxt[s])
                    out[req.req_id].append(tok)
                    n_gen[s] += 1
                    cur[s] = tok
                    done = (n_gen[s] >= req.max_new
                            or (self.eos_id is not None
                                and tok == self.eos_id)
                            or pos[s] + 2 >= self.max_len)
                    if done:
                        admit(s)
                        continue
                pos[s] += 1
        return out
