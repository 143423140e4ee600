"""Training traffic: steps of one batch shape through the program's
`Trainer.run` -> `make_train_step` (microbatches, remat, AdamW), back to
back.  The traffic file gives the sequence length, the global batch, the
microbatch, remat, and how many first steps the reference follows.

Set-up draws the weights from the seed (`core.make_weights`), hands them
to a `Trainer` in place of its own draw with a zero optimizer state, and
drives it through its first steps with the feed the window uses; those
steps are the warm-up and what the output check compares.  The window
runs one step after another until `--seconds` have passed.  Each step's
rows are drawn on the device from the seed and the step's index, so every
row differs.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import torch

from core import (PROGRAM_PATH, make_weights, program_leaf, program_params,
                  sub_seed)

ROWS_TAG = 2


class Feed:
    """Step k's batch: (B, S + 1) token ids drawn on the device from the
    seed and k; tokens are the first S, labels the last S."""

    def __init__(self, seed, vocab, batch, seq_len, device):
        self.seed, self.vocab = seed, vocab
        self.batch_rows, self.seq_len, self.device = batch, seq_len, device

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=self.device).manual_seed(
            sub_seed(self.seed, ROWS_TAG, step))
        ids = torch.randint(0, self.vocab, (self.batch_rows, self.seq_len + 1),
                            generator=gen, device=self.device)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.seq_len = ctx.clip(t["seq_len"])
        self.batch = t["global_batch"]
        self.microbatch = t["microbatch"]
        self.check_steps = t["check_steps"]
        self.tokens_per_step = self.batch * self.seq_len

    def setup(self):
        from repro_torch.configs.base import RunConfig
        from repro_torch.train.train_step import TrainState
        from repro_torch.train.trainer import Trainer
        ctx = self.ctx
        run_cfg = RunConfig(model=ctx.model_cfg, mode="train",
                            seq_len=self.seq_len, global_batch=self.batch,
                            microbatch=self.microbatch,
                            remat=ctx.traffic["remat"])
        trainer = Trainer(ctx.model_cfg, run_cfg, seed=0, device=ctx.device,
                          log_every=1 << 30)
        trainer.state = None    # its own draw, replaced by the seed's
        gc.collect()
        params = program_params(make_weights(ctx.shapes, ctx.seed, ctx.device,
                                             ctx.dtype))
        trainer.state = TrainState(params=params,
                                   opt=trainer.opt.init(params))
        del params
        trainer.data = Feed(ctx.seed, ctx.shapes["vocab"], self.batch,
                            self.seq_len, ctx.device)
        self.trainer = trainer
        gc.collect()
        if ctx.on_card:
            torch.cuda.empty_cache()
        # the first steps: the warm-up, and what the reference follows
        losses, grads = [], None
        for k in range(self.check_steps):
            losses.append(self.step()["loss"][0])
            if k == 0:          # Adam's first moment is (1 - b1) g
                grads = {n: program_leaf(trainer.state.opt.m, n).norm()
                         / (1.0 - trainer.opt.b1) for n in PROGRAM_PATH}
        w0 = make_weights(ctx.shapes, ctx.seed, ctx.device, ctx.dtype)
        change = {n: (program_leaf(trainer.state.params, n).float()
                      - w0[n].float()).norm() for n in PROGRAM_PATH}
        del w0
        opt = trainer.state.opt
        self.readings = {
            "loss": losses,
            "grad": {n: float(g) for n, g in grads.items()},
            "change": {n: float(c) for n, c in change.items()},
            "m": {n: float(program_leaf(opt.m, n).norm())
                  for n in PROGRAM_PATH},
            "v": {n: float(program_leaf(opt.v, n).norm())
                  for n in PROGRAM_PATH}}

    def step(self):
        """One step through `Trainer.run`, the window's own call."""
        hist = self.trainer.run(1)
        self.trainer.start_step += 1
        return hist

    def window(self, seconds: float, span) -> List[dict]:
        items = []
        t0 = time.perf_counter()
        while True:
            with span("bench.train_step"):
                start = time.perf_counter()
                self.step()             # ends on the loss's host read
                end = time.perf_counter()
            items.append({"tokens": self.tokens_per_step, "start": start,
                          "end": end, "seq_len": self.seq_len,
                          "rows": self.batch})
            if end - t0 >= seconds:
                return items

    def release(self):
        """Drop the program's state before the reference runs."""
        del self.trainer
        gc.collect()
        if self.ctx.on_card:
            torch.cuda.empty_cache()

    def reference(self, quant=None, keep_rows=None) -> dict:
        """The plain reference's readings over the same first steps."""
        from reference import lm
        ctx = self.ctx
        lm.exact_float32()
        w = make_weights(ctx.shapes, ctx.seed, ctx.device, ctx.dtype)
        feed = Feed(ctx.seed, ctx.shapes["vocab"], self.batch, self.seq_len,
                    ctx.device)
        batches = (feed.batch(k) for k in range(self.check_steps))
        return lm.train(w, ctx.shapes, batches,
                        self.batch // self.microbatch, quant=quant,
                        keep_rows=keep_rows)

    def compare(self, got: dict, ref: dict) -> Dict[str, float]:
        """The numbers the output check compares: the largest gap of a
        step's loss (nats); by the worst leaf, the gap between the norms of
        step 1's gradient, of the parameters' change over the followed
        steps, and of AdamW's float32 moments m and v after them, each over
        the larger of the reference leaf's norm and the median leaf's.  The
        change leaves out leaves whose reference gradient is under a
        thousandth of the median leaf's (rounding alone moves them)."""
        med_g = statistics.median(ref["grad"].values())
        moved = [n for n in ref["grad"] if ref["grad"][n] >= 1e-3 * med_g]

        def worst(key, leaves):
            med = statistics.median(ref[key].values())
            return max(abs(got[key][n] - ref[key][n]) / max(ref[key][n], med)
                       for n in leaves)

        return {
            "loss_gap": max(abs(a - b) for a, b in zip(got["loss"],
                                                       ref["loss"])),
            "grad_norm_gap": worst("grad", ref["grad"]),
            "change_norm_gap": worst("change", moved),
            "moment_norm_gap": max(worst("m", ref["m"]),
                                   worst("v", ref["v"])),
        }

    def check(self) -> Dict[str, float]:
        self.release()
        return self.compare(self.readings, self.reference())

    def control(self) -> Dict[str, Dict]:
        """The numbers of the control (the reference in float8, in the
        program's place) and of the fault of a step that leaves half its
        batch out (the reference over the first half of each batch), each
        compared with the float32 reference as a run's are."""
        exact = self.reference()
        return {"control": self.compare(self.reference(quant="fp8"), exact),
                "faults": {"half_batch": self.compare(
                    self.reference(keep_rows=self.batch // 2), exact)}}
