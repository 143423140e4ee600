"""Training loop: data -> step -> metrics, with checkpoint/restart and a
step watchdog, as `repro/train/trainer.py`.

The single-process loop on one device (default the card).  The state is
the reference's `TrainState`, so checkpoints carry the same leaf keys and
either package's `Trainer` resumes the other's.  `float(metrics["loss"])`
is the step's one host read.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tracing
from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         restore_checkpoint)
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.runtime.fault_tolerance import StepWatchdog, retry_step
from repro_torch.train.train_step import init_train_state, make_train_step

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class Trainer:
    model_cfg: ModelConfig
    run_cfg: RunConfig
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    seed: int = 0
    log_every: int = 10
    on_metrics: Optional[Callable[[int, Dict], None]] = None
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.state, self.opt = init_train_state(gen, self.model_cfg,
                                                self.run_cfg)
        self.step_fn = make_train_step(self.model_cfg, self.run_cfg,
                                       self.opt)
        self.data = SyntheticLM(self.model_cfg, self.run_cfg, seed=self.seed,
                                device=self.device)
        self.start_step = 0
        self.ckpt_mgr = None
        if self.ckpt_dir is not None:
            self.ckpt_mgr = CheckpointManager(self.ckpt_dir, self.ckpt_every)
            last = latest_step(self.ckpt_dir)
            if last is not None:
                log.info("resuming from checkpoint step %d", last)
                self.state = restore_checkpoint(self.ckpt_dir, last,
                                                self.state)
                self.start_step = last

    def run(self, n_steps: int) -> Dict[str, list]:
        """Runs n_steps steps; returns their history, a list a key with
        one entry a step: "loss", "step", "dt" (host seconds of the update
        and its loss read) and "retries" (the attempts `retry_step` ran
        again after a `RuntimeError`).  A step is the span
        `train.step`: its batch draw (`train.batch`), the update and the
        loss read (`train.host_read`)."""
        history: Dict[str, list] = {"loss": [], "step": [], "dt": [],
                                    "retries": []}
        watchdog = StepWatchdog()
        for step in range(self.start_step, self.start_step + n_steps):
            retried = []
            with tracing.span("train.step"):
                with tracing.span("train.batch"):
                    batch = self.data.batch(step)
                t0 = time.monotonic()
                with watchdog:
                    self.state, metrics = retry_step(
                        lambda: self.step_fn(self.state, batch),
                        on_retry=lambda attempt, exc: retried.append(attempt))
                with tracing.span("train.host_read"):
                    loss = float(metrics["loss"])
                dt = time.monotonic() - t0
            history["loss"].append(loss)
            history["step"].append(step)
            history["dt"].append(dt)
            history["retries"].append(len(retried))
            if self.on_metrics:
                self.on_metrics(step, metrics)
            if step % self.log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", step, loss, dt)
            if self.ckpt_mgr is not None:
                self.ckpt_mgr.maybe_save(step + 1, self.state)
        if self.ckpt_mgr is not None:
            self.ckpt_mgr.wait()
        return history
