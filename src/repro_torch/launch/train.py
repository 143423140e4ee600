"""Training launcher, as `repro/launch/train.py`, on the card by default:

    python -m repro_torch.launch.train --arch stablelm-1.6b --steps 4
    python -m repro_torch.launch.train --arch glm4-9b --host-scale --device cpu

`--host-scale` shrinks the model to a CPU-trainable config of the same
family and topology (`host_scale_config`) and the shape to a sequence of
at most 128 tokens and a global batch of at most 8.  Weights are random,
drawn from a generator seeded `--seed` on the device.  The reference's
pod launch (`jax.distributed`, the mesh, sharded placement) comes with
the port's mesh (ROADMAP.md queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.train.trainer import Trainer

log = logging.getLogger("repro_torch.launch.train")


def host_scale_config(cfg):
    """Shrink an arch config to a ~CPU-trainable size, same topology."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 4 if not cfg.layer_pattern else
                     2 * len(cfg.layer_pattern)),
        d_model=256, d_ff=512 if cfg.d_ff else 0,
        n_heads=4 if cfg.n_heads else 0,
        kv_heads=min(cfg.kv_heads, 2) if cfg.kv_heads else 0,
        head_dim=64, vocab=min(cfg.vocab, 2048),
        n_experts=min(cfg.n_experts, 4), local_window=64,
        lru_width=256 if cfg.lru_width else None,
        ssm_chunk=32,
        param_dtype="float32", compute_dtype="float32",
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--host-scale", action="store_true",
                    help="shrink model + batch for single-host runs")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch)
    shape = dict(SHAPES[args.shape])
    if args.host_scale:
        cfg = host_scale_config(cfg)
        shape.update(seq_len=min(shape["seq_len"], 128),
                     global_batch=min(shape["global_batch"], 8))
    run = RunConfig(model=cfg, **shape)
    trainer = Trainer(cfg, run, ckpt_dir=args.ckpt_dir, seed=args.seed,
                      device=args.device)
    history = trainer.run(args.steps)
    first, last = history["loss"][0], history["loss"][-1]
    log.info("done: loss %.4f -> %.4f over %d steps on %s", first, last,
             args.steps, trainer.device)
    return history


if __name__ == "__main__":
    main()
