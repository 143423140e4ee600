"""Host-clock times of the arena kernel's two solver paths, for comparing
two trees of the port on one card.

Builds `chip_smoke.py` phase 4's service (Fig. 8: n=256, stages=2, 64x64
arrays, sigma=0.05, 16 tenants x 8 rhs) and phase 5's solver (n=1024,
stages=2, 64x64: one launch per level group) from the `repro_torch` under
`--src` (default: this checkout's `src`), then prints one JSON line with
the median host-clock ms of 20 steady `flush_all` calls (the pack cached,
8 rhs a tenant submitted before each) and of 20 synchronised
`solve_many` calls.  Uses only the public API, so it drives an earlier
commit's tree as well:

    python3 probes/host_paths.py [--src path/to/src]    (on a card)
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", default=str(
        Path(__file__).resolve().parent.parent / "src"))
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("host_paths: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.core import blockamc
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.data.matrices import random_rhs, wishart
    from repro_torch.serve import SolverService

    dev = torch.device("cuda")
    n, tenants, k = 256, 16, 8
    cfg = AnalogConfig(array_size=64, nonideal=NonidealConfig(sigma=0.05))
    data = torch.Generator().manual_seed(2024)
    mats = [wishart(data, n, device=dev) for _ in range(tenants)]
    rhs = [[random_rhs(data, n, device=dev) for _ in range(k)]
           for _ in range(tenants)]
    ids = [f"tenant{i}" for i in range(tenants)]
    svc = SolverService(cfg, stages=2, device=dev)
    for i, mid in enumerate(ids):
        svc.program(mid, mats[i], torch.Generator().manual_seed(i))

    def flush_ms():
        for mid, cols in zip(ids, rhs):
            for b in cols:
                svc.submit(mid, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.flush_all()
        return (time.perf_counter() - t0) * 1e3

    big = blockamc.ProgrammedSolver.program(
        wishart(data, 1024, device=dev), torch.Generator().manual_seed(7),
        cfg, 2, device=dev)
    b_big = torch.stack([random_rhs(data, 1024, device=dev)
                         for _ in range(k)], dim=1)

    def level_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        big.solve_many(b_big)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for fn in (flush_ms, level_ms):      # warm-up: builds, caches
        fn()
        fn()
    out = dict(src=args.src,
               flush_all_ms=statistics.median(
                   flush_ms() for _ in range(args.reps)),
               solve_many_ms=statistics.median(
                   level_ms() for _ in range(args.reps)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
