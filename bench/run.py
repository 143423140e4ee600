#!/usr/bin/env python3
"""Runs one cell of the benchmark on the card this process is started on:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's name leads, through `BENCHMARK.json`, to its configuration
file, its traffic file (`bench/traffic/<mix>.json`, whose `driver` names
`bench/drivers/<driver>.py`), its output check's limits
(`bench/limits/<cell>.json`) and a reader for each metric it reports
(`bench/metrics/<metric>.py`).  The run draws its weights and inputs
from the seed, sets up and warms up the program (`repro_torch`), measures
for `--seconds`, checks what the timed path produced against the plain
reference (`bench/reference/`), and prints one JSON line last: the
end-to-end metrics with `--trace 0`, the per-layer ones with `--trace 1`
(`torch.profiler` over the window).  The numbers compared, each beside
its limit, are the last lines on standard error and the result's last
key.

It exits without a result where the card or the cell's chips are
missing, or where JAX or the JAX package (`repro`) got loaded.
"""
from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

import core  # noqa: E402
from window_trace import Tracer  # noqa: E402

HOST_SCALE_LEN = 64     # the longest sequence of a host-scale run (tests)


def process_age() -> float:
    """Seconds since this process started (its start time in
    /proc/self/stat against the uptime), else since this module loaded."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's files, the seed, the device, the
    program's model configuration and the sizes from the configuration
    file."""
    cell: Any
    seed: int
    device: Any
    model_cfg: Any
    shapes: dict
    dtype: Any
    host_scale: bool

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def clip(self, n: int) -> int:
        return min(n, HOST_SCALE_LEN) if self.host_scale else n


def build_context(cell, seed: int, device, host_scale: bool) -> Context:
    """The program's configuration of the cell's model, held to the
    configuration file's numbers; at host scale (the tests) shrunk by the
    program's `host_scale_config`."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(cell.config["model"])
    shapes = cell.shapes()
    wrong = {f: (v, getattr(cfg, f)) for f, v in shapes.items()
             if getattr(cfg, f) != v}
    if wrong:
        raise SystemExit(f"{cell.config_entry['file']}: the program's "
                         f"configuration differs: {wrong}")
    if host_scale:
        from repro_torch.launch.train import host_scale_config
        cfg = host_scale_config(cfg)
        shapes = {f: getattr(cfg, f) for f in shapes}
    dtype = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[shapes["param_dtype"]]
    return Context(cell, seed % 2 ** 63, device, cfg, shapes, dtype,
                   host_scale)


def power_limit() -> Optional[str]:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


@dataclasses.dataclass
class Run:
    """What the metric readers read: the window's work, its times, the
    trace's reduction and the memory peak, with the configuration's
    sizes."""
    items: list
    setup_s: float
    window_s: float
    trace: Optional[dict]
    memory_peak_bytes: int
    shapes: dict
    on_card: bool


def judge(numbers: dict, limits: dict) -> dict:
    """`correct` and each number compared beside its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return {"correct": all(c["value"] <= c["limit"]
                           for c in checks.values()), "checks": checks}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             host_scale: bool = False, power: Optional[str] = None) -> dict:
    """One run of a cell; returns the result line as a dict."""
    import torch
    cell = core.Cell(name)
    device = torch.device(device)
    ctx = build_context(cell, seed, device, host_scale)
    drv = cell.driver().Driver(ctx)
    drv.setup()
    sync = torch.cuda.synchronize if ctx.on_card else (lambda: None)
    sync()
    setup_s = process_age()
    gc.collect()
    if ctx.on_card:
        torch.cuda.reset_peak_memory_stats()
    tracer = Tracer(trace, ctx.on_card)
    with tracer:
        items = drv.window(seconds, tracer.span)
        sync()
    peak = torch.cuda.max_memory_allocated() if ctx.on_card else 0
    t0 = time.perf_counter()
    summary = tracer.summary() if trace else None
    t1 = time.perf_counter()
    numbers = drv.check()
    t2 = time.perf_counter()
    run = Run(items, setup_s, items[-1]["end"] - items[0]["start"], summary,
              peak, ctx.shapes, ctx.on_card)
    notes = [f"{len(items)} in a window of {run.window_s:.3f} s; the "
             f"trace reduced in {t1 - t0:.1f} s, the output checked in "
             f"{t2 - t1:.1f} s"]
    if trace:
        notes += [f"kernel {s:.6f} s {k[:160]}" for k, s in sorted(
            summary["kernels"].items(), key=lambda kv: -kv[1])[:12]]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        mod = core.reader(m["name"])
        value = mod.read(run)
        if value is None:
            if not trace:
                raise SystemExit(f"{name}: no reading of {m['name']}")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if getattr(mod, "BASIS", None):
            notes.append(f"{m['name']} = {value} {m['unit']} of "
                         f"{mod.BASIS}, card power limit {power}")
    verdict = judge(numbers, cell.limits)
    result = {
        "correct": verdict["correct"],
        "attempted": len(items), "failed": 0, "metrics": metrics,
        "device": {"platform": "gpu" if ctx.on_card else device.type,
                   "kind": (torch.cuda.get_device_name(device)
                            if ctx.on_card else device.type),
                   "count": cell.chips, "memory_peak_bytes": peak,
                   "power_limit": power},
    }
    if trace:
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["notes"] = notes
    result["checks"] = verdict["checks"]
    return result


def control_cell(name: str, seed: int, device,
                 host_scale: bool = False) -> dict:
    """The cell's control - the plain reference in float8 put in the
    program's place - and the faults the driver can plant in that place,
    each judged by `judge` against the cell's own limits, as a run's
    output is.  The benchmark's runs never call this (`calibrate.py`)."""
    import torch
    cell = core.Cell(name)
    ctx = build_context(cell, seed, torch.device(device), host_scale)
    got = cell.driver().Driver(ctx).control()
    return {"control": judge(got["control"], cell.limits),
            "faults": {k: judge(v, cell.limits)
                       for k, v in got["faults"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    chips = core.Cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", power=power_limit())
    found = core.forbidden_modules()
    if found:
        print(f"loaded in this process, which the benchmark forbids: "
              f"{found}", file=sys.stderr)
        return 4
    for note in result.pop("notes"):
        print(note, file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
