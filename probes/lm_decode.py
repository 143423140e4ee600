"""The unsharded glm4-9b decode step of `chip_smoke.py`'s phase 12, timed
on its own, for comparing two trees on one card.

Imports `repro_torch` from `--tree`'s `src` (default: this checkout),
draws glm4-9b at full size from phase 12's seeds, prefills phase 12's
(4, 1024) prompt with `make_prefill_step(cfg, 1056)` and times `--steps`
greedy `make_decode_step` steps after it, `--reps` times (each run
synchronised once at its end, host clock; the first is a warm-up and is
left out).  Prints one JSON line: the tree, the card, and the ms a step
of each timed run.  Run each tree in its own process:

    python3 probes/lm_decode.py [--tree path/to/checkout] [--steps 32]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(
        Path(__file__).resolve().parent.parent))
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--reps", type=int, default=4)
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    from repro_torch.models.serve_step import (make_decode_step,
                                               make_prefill_step)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = get_config("glm4-9b")
    params = tr.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    b, s = 4, 1024
    prompts = torch.randint(0, cfg.vocab, (b, s), device=dev,
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(1))
    prefill = make_prefill_step(cfg, s + args.steps)
    decode = make_decode_step(cfg)
    runs = []
    with torch.no_grad():
        for _ in range(args.reps + 1):
            tok, cache = prefill(params, {"tokens": prompts})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(args.steps):
                tok, cache = decode(params, cache, tok, s + i, None)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / args.steps * 1e3)
    print(json.dumps({"tree": str(tree), "card": smi,
                      "decode_ms_a_step": runs[1:]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
