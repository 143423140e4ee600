"""A planted fault for `chip_smoke.py`'s phase 18 (b): shows that its
check of the sharded training step fails when one gradient is wrong.

Runs the tree's `_mesh_train` on a one-rank NCCL mesh with the sharded
step's gradient of the final norm (`ln_f`, the only parameter of its
shape) zeroed where `make_train_step` lays the gradients out.  The
unsharded step is untouched.  Prints one JSON line: whether the phase's
check failed, and its message.  Exits 0 when the check caught the
fault, 1 when it did not.

    python3 probes/mesh_fault.py [--tree path/to/checkout]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(
        Path(__file__).resolve().parent.parent))
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import chip_smoke
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import train_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    mesh = make_host_mesh(1, 1, device=dev)
    d_model = get_config(chip_smoke.TRAIN_ARCH).d_model
    real = train_step.lay_out

    def faulty(g, mesh, placements):
        out = real(g, mesh, placements)
        return out * 0 if tuple(out.shape) == (d_model,) else out

    train_step.lay_out = faulty
    try:
        chip_smoke._mesh_train(dev, smi, mesh)
        caught, message = False, None
    except AssertionError as e:
        caught, message = True, str(e)
    finally:
        train_step.lay_out = real
        dist.destroy_process_group()
    print(json.dumps({"card": smi, "planted": "ln_f gradient zeroed in the "
                      "sharded step", "caught": caught,
                      "message": message}))
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
