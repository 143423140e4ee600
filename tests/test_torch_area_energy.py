"""The port's Fig. 10 hardware model (`core/area_energy.py`) and macro
schedule model (`core/macro.py`) against the JAX package's.  Both are pure
Python with the same arithmetic, so every number must be equal exactly."""
import dataclasses

import pytest

from repro.core import area_energy as j_ae
from repro.core import macro as j_macro
from repro_torch.core import area_energy as t_ae
from repro_torch.core import macro as t_macro


@pytest.mark.parametrize("n", [512, 256, 1024])
def test_report_and_savings_equal_the_reference(n):
    assert t_ae.report(n) == j_ae.report(n)
    assert t_ae.savings(t_ae.report(n)) == j_ae.savings(j_ae.report(n))


def test_headline_savings_are_the_papers():
    sav = t_ae.savings(t_ae.report())
    assert sav == j_ae.savings(j_ae.report())
    assert round(sav["area"]["one_stage"], 4) == 0.4883
    assert round(sav["power"]["one_stage"], 4) == 0.4
    assert round(sav["area"]["two_stage"], 4) == 0.123
    assert round(sav["power"]["two_stage"], 4) == 0.374


def test_calibration_and_breakdown_equal_the_reference():
    cal_t, cal_j = t_ae.solve_calibration(), j_ae.solve_calibration()
    assert {k: dataclasses.asdict(v) for k, v in cal_t.items()} == \
        {k: dataclasses.asdict(v) for k, v in cal_j.items()}
    for solver in ("original", "one_stage", "two_stage"):
        assert t_ae.breakdown(128, solver, cal_t["area"]) == \
            j_ae.breakdown(128, solver, cal_j["area"])
    with pytest.raises(ValueError):
        t_ae.breakdown(128, "three_stage", cal_t["area"])


@pytest.mark.parametrize("solver", ["original", "one_stage", "two_stage"])
@pytest.mark.parametrize("n_solves", [1, 4, 16])
def test_solver_performance_equals_the_reference(solver, n_solves):
    assert t_macro.solver_performance(solver, n_solves) == \
        j_macro.solver_performance(solver, n_solves)


def test_dags_equal_the_reference():
    for name in ("one_stage_dag", "two_stage_dag"):
        ours = [dataclasses.astuple(op) for op in getattr(t_macro, name)()]
        theirs = [dataclasses.astuple(op)
                  for op in getattr(j_macro, name)()]
        assert ours == theirs
    assert t_macro.solver_performance("one_stage", 1)["latency_cycles"] == 5
