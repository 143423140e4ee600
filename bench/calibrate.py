#!/usr/bin/env python3
"""Readings that set the limits of a cell's output check, on the card at
the cell's own size (the benchmark's own runs never run this):

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,13

For each seed, the control - the plain reference computed in float8 in
the program's place - and, for training, the fault of a step that leaves
half its batch out, each read by the numbers a run compares and judged
against the cell's limits by the same `correct` (`run.control_cell`).
One JSON line a seed.  The program's own readings are those its runs
print."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from run import control_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate.py needs the card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control_cell(args.workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
