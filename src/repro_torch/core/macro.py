"""BlockAMC macro schedule model (paper Section III.B), copied from
`repro/core/macro.py` (pure Python; the port keeps its own copy).

"In every clock cycle, an MVM or INV operation is accomplished."  The macro
shares one set of OPAs among its four arrays (transmission-gate reconfig),
so its five steps are strictly sequential; S&H double buffering lets a
*stream* of right-hand sides pipeline through.  The two-stage solver deploys
four one-stage macros on a bus with per-macro OPA sets for INV and MVM.

This is a resource-constrained list scheduler over the operation DAG - the
behavioural stand-in for Fig. 4(b)'s clock controller.  It reports latency
(cycles until the first solve completes), steady-state initiation interval
(cycles between successive solve completions), and per-solve energy from the
recovered unit powers of `area_energy`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    resource: str           # which OPA set executes it
    deps: Tuple[int, ...]   # indices of ops that must complete first


def one_stage_dag() -> List[Op]:
    """The five-step cascade on one shared OPA set."""
    r = "macro0"
    return [
        Op("inv_A1_f", r, ()),        # step 1
        Op("mvm_A3", r, (0,)),        # step 2
        Op("inv_A4s", r, (1,)),       # step 3
        Op("mvm_A2", r, (2,)),        # step 4
        Op("inv_A1_fs", r, (3,)),     # step 5
    ]


def two_stage_dag() -> List[Op]:
    """Stage-1 cascade where each INV expands into a 5-op stage-2 cascade
    on its own macro, and stage-1 MVMs run on dedicated MVM OPA sets
    ("OPAs are separately deployed for the first-stage INV and MVM")."""
    ops: List[Op] = []

    def inv_block(macro: str, deps: Tuple[int, ...]) -> Tuple[int, ...]:
        base = len(ops)
        ops.append(Op(f"{macro}.inv_A1_f", macro, deps))
        ops.append(Op(f"{macro}.mvm_A3", macro, (base,)))
        ops.append(Op(f"{macro}.inv_A4s", macro, (base + 1,)))
        ops.append(Op(f"{macro}.mvm_A2", macro, (base + 2,)))
        ops.append(Op(f"{macro}.inv_A1_fs", macro, (base + 3,)))
        return (base + 2, base + 4)   # outputs: z at step3, y at step5

    s1 = inv_block("macroA1", ())                    # stage-1 step 1
    m2 = len(ops)
    ops.append(Op("mvm_A3_s1", "mvm_set", s1))       # stage-1 step 2
    s3 = inv_block("macroA4s", (m2,))                # stage-1 step 3
    m4 = len(ops)
    ops.append(Op("mvm_A2_s1", "mvm_set", s3))       # stage-1 step 4
    inv_block("macroA1", (m4,))                      # stage-1 step 5 (reuse)
    return ops


def schedule(ops: List[Op], n_solves: int = 1) -> Dict[str, float]:
    """Greedy list schedule of `n_solves` back-to-back solves.

    Each op takes one clock cycle; each resource runs one op per cycle; an
    op may start once its deps (within its own solve instance) are done.
    S&H double buffering means an op's output is available the next cycle.
    """
    total = []
    for s in range(n_solves):
        for op in ops:
            total.append(Op(f"s{s}.{op.name}", op.resource,
                            tuple(d + s * len(ops) for d in op.deps)))
    finish: List[Optional[int]] = [None] * len(total)
    busy_until: Dict[str, int] = {}
    t = 0
    remaining = set(range(len(total)))
    completion_per_solve = [0] * n_solves
    while remaining:
        # ready ops whose deps are finished by cycle t
        launched = set()
        for i in sorted(remaining):
            op = total[i]
            if any(finish[d] is None or finish[d] > t for d in op.deps):
                continue
            if busy_until.get(op.resource, -1) >= t:
                continue
            busy_until[op.resource] = t
            finish[i] = t + 1
            launched.add(i)
        remaining -= launched
        t += 1
        if t > 100 * len(total):
            raise RuntimeError("scheduler wedged")
    for i, op in enumerate(total):
        s = int(op.name.split(".")[0][1:])
        completion_per_solve[s] = max(completion_per_solve[s], finish[i])
    latency = completion_per_solve[0]
    if n_solves > 1:
        ii = (completion_per_solve[-1] - completion_per_solve[0]) / (n_solves - 1)
    else:
        ii = float(latency)
    return {"latency_cycles": float(latency),
            "initiation_interval": float(ii),
            "makespan": float(max(completion_per_solve))}


def solver_performance(solver: str, n_solves: int = 16) -> Dict[str, float]:
    """Latency/II for 'original' (1 cycle), one- or two-stage macros."""
    if solver == "original":
        return {"latency_cycles": 1.0, "initiation_interval": 1.0,
                "makespan": float(n_solves)}
    dag = one_stage_dag() if solver == "one_stage" else two_stage_dag()
    return schedule(dag, n_solves)
