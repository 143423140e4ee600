"""Shared pieces of the benchmark: where its files are, how a cell's
configuration, traffic mix, limits, driver and metric readers are found
by the names in `BENCHMARK.json`, seeds, the weights every cell draws,
and the import check.

Nothing here imports the program (`repro_torch`) at import time; the
drivers do, when a cell runs.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names that no run of the benchmark may load: the JAX
# package's own (`repro`), JAX's, and the JAX package's drivers.  Compared
# whole: `repro_torch` is the program and passes.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path):
    """A module from its file, whatever characters its name holds (a
    metric reader is named after its metric: `flash_roofline.prefill`)."""
    name = "bench_" + "".join(c if c.isalnum() else "_"
                              for c in str(path.relative_to(BENCH)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of `BENCHMARK.json` with everything its names lead to:
    the configuration's file, the traffic mix's file, the limits of its
    output check, and the metrics it reports."""

    def __init__(self, name: str, spec: dict | None = None):
        spec = load_spec() if spec is None else spec
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(ROOT / self.config_entry["file"])
        self.traffic = load_json(
            BENCH / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(BENCH / "limits" / f"{name}.json")
        self.end_to_end = [m for m in spec["end_to_end"] if self.reports(m)]
        self.per_layer = [m for m in spec["per_layer"] if self.reports(m)]
        self.chips = self.workload["chips"]

    def reports(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def driver(self):
        return load_module(BENCH / "drivers" / f"{self.traffic['driver']}.py")

    def shapes(self) -> dict:
        """The model's sizes under the program's field names, read from the
        configuration's file (its `program_keys` map each published key
        to the field it sets), never from the program."""
        return {field: self.config[key]
                for key, field in self.config["program_keys"].items()}


def reader(metric: str):
    """The reader of a metric: `bench/metrics/<metric>.py`, whose
    `read(run)` returns the metric's value, or None where the run holds
    nothing to read."""
    return load_module(BENCH / "metrics" / f"{metric}.py")


def sub_seed(seed: int, *tags: int) -> int:
    """A seed for one stream of a run (the weights, one step's rows, one
    request's prompt), drawn from `--seed` and the stream's tags."""
    state = np.random.SeedSequence([int(seed), *tags]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# Weights: one layout for the program and the reference
# ---------------------------------------------------------------------------

WEIGHTS_TAG = 1
# Where each weight sits in the program's parameter tree (a dense
# attention unit, stacked over the layers).
PROGRAM_PATH = {
    "embed": ("embed",), "head": ("head",), "ln_f": ("ln_f",),
    "ln1": ("blocks", "b0", "ln1"), "ln2": ("blocks", "b0", "ln2"),
    "wq": ("blocks", "b0", "mix", "wq"), "wk": ("blocks", "b0", "mix", "wk"),
    "wv": ("blocks", "b0", "mix", "wv"), "wo": ("blocks", "b0", "mix", "wo"),
    "gate": ("blocks", "b0", "ffn", "gate"),
    "up": ("blocks", "b0", "ffn", "up"),
    "down": ("blocks", "b0", "ffn", "down"),
}


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


def weight_layout(sh: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, std) of every weight of a dense decoder; std 0 for the
    norms' weights, which start at zero (scale 1 + w).  Matrices are
    stacked over the layers; std 1/sqrt(fan-in), the embedding 0.02."""
    d, nl, f = sh["d_model"], sh["n_layers"], sh["d_ff"]
    q, kv = sh["n_heads"] * sh["head_dim"], sh["kv_heads"] * sh["head_dim"]
    v = padded_vocab(sh["vocab"])
    return [("embed", (v, d), 0.02), ("head", (d, v), d ** -0.5),
            ("wq", (nl, d, q), d ** -0.5), ("wk", (nl, d, kv), d ** -0.5),
            ("wv", (nl, d, kv), d ** -0.5), ("wo", (nl, q, d), q ** -0.5),
            ("gate", (nl, d, f), d ** -0.5), ("up", (nl, d, f), d ** -0.5),
            ("down", (nl, f, d), f ** -0.5),
            ("ln_f", (d,), 0.0), ("ln1", (nl, d), 0.0), ("ln2", (nl, d), 0.0)]


def make_weights(sh: dict, seed: int, device, dtype) -> Dict:
    """Every weight, drawn on `device` from the seed in one call into one
    buffer of `dtype` (the type they are served in) and scaled in place;
    the norms' weights float32 zeros.  The same seed gives the same
    weights, so the reference draws them again after the program's
    window instead of reading anything the program held."""
    import torch
    layout = weight_layout(sh)
    mats = [(n, s, std) for n, s, std in layout if std]
    total = sum(int(np.prod(s)) for _, s, _ in mats)
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, WEIGHTS_TAG))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, std in mats:
        n = int(np.prod(shape))
        out[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    for name, shape, std in layout:
        if not std:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out


def program_params(weights: Dict) -> Dict:
    """The program's parameter tree over the same tensors (no copies)."""
    tree: Dict = {}
    for name, path in PROGRAM_PATH.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = weights[name]
    return tree


def program_leaf(tree: Dict, name: str):
    node = tree
    for key in PROGRAM_PATH[name]:
        node = node[key]
    return node
