"""Pauses of Python's cyclic garbage collector inside `chip_smoke.py`'s
phase 14 (the replicated fleet), for comparing two trees on one card.

Imports `chip_smoke.py` from `--tree` (default: this checkout), runs its
`main()` - phases 1-13 as the script runs them - and replaces phase 14 by
`--runs` runs of that tree's own `_fleet_phase`, each with every
collection timed (`gc.callbacks`).  Prints one JSON line: the objects the
collector tracks before phase 14, and for each run its outcome (the
death_restore and death_reprogram p99, or the error that stopped it), the
number of collections, their total time and the five longest as
(generation, ms, objects collected).  Phase 15 and the kernels line do
not run.  Any error of phases 1-13 stops the probe.

    python3 probes/fleet_gc.py [--tree path/to/checkout] [--runs 2]
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(
        Path(__file__).resolve().parent.parent))
    parser.add_argument("--runs", type=int, default=2)
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke

    pauses = []
    started = {}

    def timer(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        else:
            pauses.append((info["generation"],
                           (time.perf_counter() - started["t"]) * 1e3,
                           info["collected"]))

    report = {"tree": str(tree), "runs": []}
    fleet_phase = chip_smoke._fleet_phase

    def probed(dev, smi, root, **kw):
        report["tracked_objects"] = len(gc.get_objects())
        report["card"] = smi
        gc.callbacks.append(timer)
        for _ in range(args.runs):
            pauses.clear()
            try:
                _, st = fleet_phase(dev, smi, root, **kw)
                run = {key: st[key]["p99_ms"]
                       for key in ("death_restore", "death_reprogram")}
            except Exception as e:              # the probe's own outcome
                run = {"error": f"{type(e).__name__}: {e}"}
            run.update(collections=len(pauses),
                       total_ms=sum(p[1] for p in pauses),
                       longest=sorted(pauses, key=lambda p: -p[1])[:5])
            report["runs"].append(run)
        gc.callbacks.remove(timer)
        print(json.dumps(report))
        raise SystemExit(0)

    chip_smoke._fleet_phase = probed
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
