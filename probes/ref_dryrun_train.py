"""The reference's train_4k dry-run cells: each chip's peak, FLOPs and
collective bytes, the yardstick of `chip_smoke.py` phase 19's train cells.

Runs the JAX package's own `repro.launch.dryrun.lower_cell` for each
train_4k cell on its 16x16 production mesh of 256 fake XLA host devices,
and prints one line a cell and a JSON object of all of them last:

    PYTHONPATH=src python probes/ref_dryrun_train.py [ARCH ...]

"peak" is XLA's `memory_analysis`: argument plus temp bytes.  On jax
0.9.0 `jax.make_mesh` gives `Explicit` axes, on which the reference's
`with_sharding_constraint` raises; the probe wraps `jax.make_mesh` to ask
for `Auto` axes (the one-line cure `tests/test_torch_pipeline.py` applies
to the reference's pipeline), and points the reference's `ARTIFACT_DIR`
at a temporary directory.  Nothing under `src/` is edited or written.
This is the one script of the port's side that imports the JAX package;
it runs on a host, never on the card.
"""
import json
import sys
import tempfile
import time

from repro.launch import dryrun          # sets the 512-device flag first

import jax                               # noqa: E402
from repro.configs import ARCHS          # noqa: E402

_make_mesh = jax.make_mesh


def _auto_mesh(shape, axes, *args, **kwargs):
    kwargs.setdefault("axis_types",
                      (jax.sharding.AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, *args, **kwargs)


def main(archs):
    jax.make_mesh = _auto_mesh
    dryrun.ARTIFACT_DIR = tempfile.mkdtemp(prefix="ref_dryrun_")
    out = {}
    for arch in archs:
        t0 = time.perf_counter()
        r = dryrun.lower_cell(arch, "train_4k")
        mem = r["memory"]
        peak = mem["argument_bytes"] + mem["temp_bytes"]
        out[arch] = {"peak_bytes": peak,
                     "flops_per_chip": r["flops_per_chip"],
                     "collective_bytes_per_chip":
                         r["collective_bytes_per_chip"],
                     "seconds": time.perf_counter() - t0}
        print(f"{arch} train_4k 16x16: peak {peak / 1e9:.3f} GB, "
              f"{r['flops_per_chip']:.4e} FLOPs, "
              f"{r['collective_bytes_per_chip']:.4e} collective bytes a "
              f"chip ({out[arch]['seconds']:.1f} s)", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:] or list(ARCHS))
