"""The reference's serving and solver dry-run cells: each chip's peak,
FLOPs and collective bytes, the yardstick of `chip_smoke.py` phase 19 (d)
and `tests/test_torch_dryrun_serve.py` (`REF_SERVE`).

Runs the JAX package's own `repro.launch.dryrun.lower_cell` for each
(arch, shape) serving cell, and `lower_solver_cell` for each solver cell,
on a production mesh of 256 (16x16) or 512 (2x16x16) fake XLA host
devices, and prints one line a cell and a JSON object of all of them
last, keyed "arch|shape|mesh":

    PYTHONPATH=src python probes/ref_dryrun_serve.py [--mesh 16x16]
        [--shapes prefill_32k,decode_32k,long_500k] [--solver n2048_s1,...]
        [--no-lm] [ARCH ...]

"peak" is XLA's `memory_analysis`: argument plus temp bytes.  Cells the
reference skips (long_500k of a full-attention arch) are left out.  As
`probes/ref_dryrun_train.py` does, the probe asks `jax.make_mesh` for
`Auto` axes (jax 0.9.0 gives `Explicit` ones, on which the reference's
`with_sharding_constraint` raises) and points the reference's
`ARTIFACT_DIR` at a temporary directory.  Nothing under `src/` is edited
or written.  It imports the JAX package and runs on a host, never on the
card.
"""
import argparse
import json
import tempfile
import time

from repro.launch import dryrun          # sets the 512-device flag first

import jax                               # noqa: E402
from repro.configs import ARCHS, get_config   # noqa: E402

_make_mesh = jax.make_mesh


def _auto_mesh(shape, axes, *args, **kwargs):
    kwargs.setdefault("axis_types",
                      (jax.sharding.AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, *args, **kwargs)


def _row(r, seconds):
    mem = r["memory"]
    return {"peak_bytes": mem["argument_bytes"] + mem["temp_bytes"],
            "argument_bytes": mem["argument_bytes"],
            "flops_per_chip": r["flops_per_chip"],
            "collective_bytes_per_chip": r["collective_bytes_per_chip"],
            "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*")
    ap.add_argument("--mesh", default="16x16", choices=("16x16", "2x16x16"))
    ap.add_argument("--shapes", default="prefill_32k,decode_32k,long_500k")
    ap.add_argument("--solver", default="n2048_s1,n16384_s2",
                    help="solver cells n<N>_s<stages>, comma separated; "
                         "'' for none")
    ap.add_argument("--no-lm", action="store_true",
                    help="the solver cells only")
    args = ap.parse_args(argv)
    jax.make_mesh = _auto_mesh
    dryrun.ARTIFACT_DIR = tempfile.mkdtemp(prefix="ref_dryrun_")
    multi_pod = args.mesh == "2x16x16"
    out = {}
    for cell in filter(None, args.solver.split(",")):
        n, stages = (int(x[1:]) for x in cell.split("_"))
        t0 = time.perf_counter()
        r = dryrun.lower_solver_cell(n=n, stages=stages, multi_pod=multi_pod)
        row = out[f"blockamc-solver|{cell}|{args.mesh}"] = _row(
            r, time.perf_counter() - t0)
        print(f"blockamc-solver {cell} {args.mesh}: argument "
              f"{row['argument_bytes']} B, peak {row['peak_bytes'] / 1e9:.4f}"
              f" GB, {row['flops_per_chip']:.4e} FLOPs, "
              f"{row['collective_bytes_per_chip']:.4e} collective bytes a "
              f"chip ({row['seconds']:.1f} s)", flush=True)
    for arch in ([] if args.no_lm else args.archs or list(ARCHS)):
        for shape in args.shapes.split(","):
            if dryrun.skip_reason(get_config(arch), shape):
                continue
            t0 = time.perf_counter()
            r = dryrun.lower_cell(arch, shape, multi_pod=multi_pod)
            row = out[f"{arch}|{shape}|{args.mesh}"] = _row(
                r, time.perf_counter() - t0)
            print(f"{arch} {shape} {args.mesh}: peak "
                  f"{row['peak_bytes'] / 1e9:.3f} GB, "
                  f"{row['flops_per_chip']:.4e} FLOPs, "
                  f"{row['collective_bytes_per_chip']:.4e} collective bytes "
                  f"a chip ({row['seconds']:.1f} s)", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
