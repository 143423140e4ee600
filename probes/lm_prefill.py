"""The unsharded prefills of `chip_smoke.py`'s phase 17 (recurrentgemma-2b
on a (2, 3072) prompt, mamba2-130m on (4, 1024)), timed on their own, for
comparing two trees on one card.

Imports `repro_torch` from `--tree`'s `src` (default: this checkout),
draws the model at full size from phase 17's seeds and times
`make_prefill_step(cfg, S + 32)` on phase 17's prompt `--reps` times,
each call synchronised at its end (host clock), after two warm-up
calls.  Prints one JSON line: the tree, the card, the model and the ms
of each timed call.  Run each tree in its own process, and alternate
them (parent, change, change, parent):

    python3 probes/lm_prefill.py [--tree path/to/checkout] \\
        [--arch recurrentgemma-2b|mamba2-130m] [--reps 8]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

SHAPES = {"recurrentgemma-2b": (2, 3072), "mamba2-130m": (4, 1024)}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(
        Path(__file__).resolve().parent.parent))
    parser.add_argument("--arch", default="mamba2-130m", choices=SHAPES)
    parser.add_argument("--reps", type=int, default=8)
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    from repro_torch.models.serve_step import make_prefill_step
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    params = tr.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    b, s = SHAPES[args.arch]
    prompts = torch.randint(0, cfg.vocab, (b, s), device=dev,
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(1))
    prefill = make_prefill_step(cfg, s + 32)
    runs = []
    with torch.no_grad():
        for i in range(args.reps + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, {"tokens": prompts})
            torch.cuda.synchronize()
            if i >= 2:
                runs.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"tree": str(tree), "card": smi, "arch": args.arch,
                      "prefill_ms": runs,
                      "median_ms": sorted(runs)[len(runs) // 2]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
