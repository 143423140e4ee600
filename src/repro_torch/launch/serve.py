"""Serving launcher: --arch <id> [--host-scale] batched generation demo,
as `repro/launch/serve.py`, on the card by default.

    python -m repro_torch.launch.serve --arch glm4-9b
    python -m repro_torch.launch.serve --arch glm4-9b --host-scale --device cpu

Weights are random, drawn from a generator seeded 0 on the device (the
full glm4-9b takes about 19 GB in bfloat16); prompts from one seeded 1.
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.train import host_scale_config
from repro_torch.models import transformer as tr
from repro_torch.models.lm_engine import Engine

log = logging.getLogger("repro_torch.launch.serve")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--host-scale", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.host_scale:
        cfg = host_scale_config(cfg)
    params = tr.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    engine = Engine(cfg, params,
                    max_len=args.prompt_len + args.gen_len + 1,
                    temperature=args.temperature)
    prompts = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len),
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.gen_len).cpu()
    dt = time.perf_counter() - t0
    tps = args.batch * args.gen_len / dt
    log.info("generated %s tokens in %.2fs (%.1f tok/s) on %s",
             tuple(out.shape), dt, tps, dev)
    print(out[:, :16])
    return out


if __name__ == "__main__":
    main()
