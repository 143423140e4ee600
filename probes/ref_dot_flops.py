"""The reference's dry-run FLOPs of one cell, dot by dot: each `dot`
instruction of the compiled, partitioned HLO with its result type, the
computation that holds it, its FLOPs once and times its execution count
(while-loop trip counts multiplied down, as the reference's
`hlo_analysis.analyze` counts them), largest first.  The yardstick for
the port's `flops_by_op` (`launch/hlo_analysis.OpAnalysis`), where the
two counts of a cell differ:

    PYTHONPATH=src python probes/ref_dot_flops.py ARCH SHAPE [--mesh 16x16]
        [--top 24]

Runs the JAX package's `repro.launch.dryrun.lower_cell` on 256 (or 512)
fake XLA host devices, with `Auto` mesh axes as
`probes/ref_dryrun_serve.py` asks for them, and reads the HLO text the
reference hands its own `analyze`.  Nothing under `src/` is edited or
written.  It imports the JAX package and runs on a host, never on the
card.
"""
import argparse
import re
import tempfile

from repro.launch import dryrun          # sets the 512-device flag first

import jax                               # noqa: E402
from repro.launch import hlo_analysis    # noqa: E402

_make_mesh = jax.make_mesh


def _auto_mesh(shape, axes, *args, **kwargs):
    kwargs.setdefault("axis_types",
                      (jax.sharding.AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, *args, **kwargs)


def dot_rows(hlo: str):
    """[(FLOPs times executions, FLOPs once, executions, result type,
    computation)] of every dot in `hlo`."""
    comps, types, entry = hlo_analysis.parse_computations(hlo)

    def attr(ins, key):
        m = re.search(key + r"=%?([\w.\-]+)", ins.attrs)
        return m.group(1) if m and m.group(1) in comps else None

    def trips(cond):
        best = None
        for ins in comps.get(cond, []):
            m = re.search(r"\b[su]\d+\[\]\s+constant\((\d+)\)", ins.line)
            if m:
                best = max(best or 0, int(m.group(1)))
        return float(best or 1)

    mult = {}

    def walk(name, m, depth=0):
        if depth > 50:
            return
        mult[name] = mult.get(name, 0.0) + m
        for ins in comps.get(name, []):
            if ins.opcode == "while":
                body, cond = attr(ins, "body"), attr(ins, "condition")
                if body:
                    walk(body, m * (trips(cond) if cond else 1.0), depth + 1)
            elif ins.opcode in ("fusion", "call", "async-start",
                                "conditional"):
                for key in ("calls", "to", "branch_computations"):
                    sub = attr(ins, key)
                    if sub:
                        walk(sub, m, depth + 1)
    walk(entry, 1.0)
    rows = []
    for name, m in mult.items():
        for ins in comps.get(name, []):
            if ins.opcode != "dot":
                continue
            lhs = types.get(ins.operands[0], "") if ins.operands else ""
            shape = hlo_analysis._SHAPE_TOKEN.search(lhs)
            dims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", ins.attrs)
            if not shape:
                continue
            lhs_shape = [int(d) for d in shape.group(2).split(",") if d]
            k = 1
            for d in (dims.group(1).split(",") if dims else []):
                if d and int(d) < len(lhs_shape):
                    k *= lhs_shape[int(d)]
            once = 2.0 * hlo_analysis._result_elems(ins.result_type) * k
            rows.append((once * m, once, m, ins.result_type[:48], name[:40]))
    return sorted(rows, key=lambda r: -r[0])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--mesh", default="16x16", choices=("16x16", "2x16x16"))
    ap.add_argument("--top", type=int, default=24)
    args = ap.parse_args(argv)
    jax.make_mesh = _auto_mesh
    dryrun.ARTIFACT_DIR = tempfile.mkdtemp(prefix="ref_dot_flops_")
    seen = []
    inner = dryrun.hlo_analysis.analyze

    def keep(hlo):
        seen.append(hlo)
        return inner(hlo)
    dryrun.hlo_analysis.analyze = keep
    r = dryrun.lower_cell(args.arch, args.shape,
                          multi_pod=args.mesh == "2x16x16")
    rows = dot_rows(seen[-1])
    total = sum(row[0] for row in rows)
    print(f"{args.arch} {args.shape} {args.mesh}: {r['flops_per_chip']:.6e} "
          f"FLOPs a chip, {total:.6e} in {len(rows)} dots")
    for flops, once, m, typ, comp in rows[:args.top]:
        print(f"  {flops:.6e}  {once:.4e} x {m:g}  {typ}  in {comp}")


if __name__ == "__main__":
    main()
