"""Area / power model of the three solver designs (paper Fig. 10), copied
from `repro/core/area_energy.py` (pure Python; the port keeps its own copy).

The paper reports, for a 512 x 512 system at FreePDK 45 nm:

    total area  : original 0.01577 mm^2, one-stage 0.00807, two-stage 0.01383
    area saving : one-stage 48.83%, two-stage 12.30%
    power saving: one-stage 40.0%,  two-stage 37.4%

with four components: OPA, DAC, ADC, RRAM array.  The paper does not publish
its per-component unit values, so we *recover* a consistent parameterisation
from the component-count structure of the three designs plus the six reported
observables (3 area totals + 2 power ratios + normalisation).  The count
structure:

    component          original      one-stage       two-stage
    OPA sets           2n amps       n amps (shared) 2n amps (per-macro INV+MVM sets)
    OPA drive width    n             n/2             n/4
    DAC channels       n             n/2             n (4 macros x n/4)
    ADC channels       n             n/2             n (4 macros x n/4)
    RRAM cells         2 n^2         2 n^2           2 n^2   (differential pairs)

OPA area/power are affine in drive width (output stage scales with the
column load): a_opa(w) = a0 + a1 * w.  Writing, for the original design,
  alpha = 2n * a0            (OPA fixed part)
  beta  = 2n * a1 * n        (OPA width-scaled part)
  delta = n * (a_dac + a_adc)
  gamma = 2 n^2 * a_cell
the three designs cost:
  original  = alpha   + beta   + delta   + gamma
  one-stage = alpha/2 + beta/4 + delta/2 + gamma
  two-stage = alpha   + beta/4 + delta   + gamma
and the reported savings pin down:
  area : beta = 4/3 * 0.1230 * T,  alpha + delta = 2*(0.4883 - 0.1230)*T,
         gamma = T - alpha - beta - delta            (T = 0.01577 mm^2)
  power: beta_p = 4/3 * 0.374 * P, alpha_p + delta_p = 2*(0.400 - 0.374)*P,
         gamma_p = P - ...                           (P normalised to 1)
The alpha:delta split inside their sum is not observable from the paper's
totals; we split 50:50 (documented free choice; it does not affect any
reported percentage).  `solve_calibration()` performs this recovery and
`breakdown()` evaluates any (n, solver) with the recovered units.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

N_PAPER = 512
AREA_TOTAL_PAPER = 0.01577          # mm^2, original AMC, n = 512
AREA_SAVING_ONE = 0.4883            # abstract: 48.83%
AREA_SAVING_TWO = 0.1230
POWER_SAVING_ONE = 0.400
POWER_SAVING_TWO = 0.374


@dataclasses.dataclass(frozen=True)
class UnitCosts:
    """Recovered per-unit areas (mm^2) and powers (normalised W)."""
    opa_fixed: float      # a0: per amplifier
    opa_per_width: float  # a1: per amplifier per unit drive width
    dac: float            # per channel
    adc: float            # per channel
    cell: float           # per RRAM cell


def _solve(total: float, s1: float, s2: float) -> tuple:
    """Recover (alpha, beta, delta, gamma) from total + two savings."""
    beta = 4.0 / 3.0 * s2 * total
    alpha_plus_delta = 2.0 * (s1 - s2) * total
    alpha = 0.5 * alpha_plus_delta   # documented 50:50 split
    delta = 0.5 * alpha_plus_delta
    gamma = total - alpha - beta - delta
    if not gamma > 0:
        raise ValueError("calibration produced negative array cost")
    return alpha, beta, delta, gamma


def solve_calibration(n: int = N_PAPER,
                      area_total: float = AREA_TOTAL_PAPER,
                      power_total: float = 1.0) -> Dict[str, UnitCosts]:
    """Recover unit areas and powers from the paper's reported numbers."""
    out = {}
    for kind, total, s1, s2 in (
            ("area", area_total, AREA_SAVING_ONE, AREA_SAVING_TWO),
            ("power", power_total, POWER_SAVING_ONE, POWER_SAVING_TWO)):
        alpha, beta, delta, gamma = _solve(total, s1, s2)
        out[kind] = UnitCosts(
            opa_fixed=alpha / (2 * n),
            opa_per_width=beta / (2 * n * n),
            dac=delta / (2 * n),       # delta = n*(dac+adc); split 50:50
            adc=delta / (2 * n),
            cell=gamma / (2 * n * n),
        )
    return out


def _counts(n: int, solver: str):
    """(amp count, amp width, dac ch, adc ch, cells) per design."""
    if solver == "original":
        return 2 * n, n, n, n, 2 * n * n
    if solver == "one_stage":
        return n, n // 2, n // 2, n // 2, 2 * n * n
    if solver == "two_stage":
        return 2 * n, n // 4, n, n, 2 * n * n
    raise ValueError(solver)


def breakdown(n: int, solver: str, units: UnitCosts) -> Dict[str, float]:
    """Component breakdown for one design at size n with given unit costs."""
    n_amp, w_amp, n_dac, n_adc, n_cell = _counts(n, solver)
    opa = n_amp * (units.opa_fixed + units.opa_per_width * w_amp)
    return {
        "opa": opa,
        "dac": n_dac * units.dac,
        "adc": n_adc * units.adc,
        "array": n_cell * units.cell,
        "total": opa + n_dac * units.dac + n_adc * units.adc + n_cell * units.cell,
    }


def report(n: int = N_PAPER) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Full Fig. 10 reproduction: area and power breakdowns, three solvers."""
    cal = solve_calibration(n=N_PAPER)
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for kind in ("area", "power"):
        out[kind] = {s: breakdown(n, s, cal[kind])
                     for s in ("original", "one_stage", "two_stage")}
    return out


def savings(rep: Dict[str, Dict[str, Dict[str, float]]]) -> Dict[str, Dict[str, float]]:
    """Savings vs original, per kind and solver - the headline numbers."""
    out = {}
    for kind, solvers in rep.items():
        t0 = solvers["original"]["total"]
        out[kind] = {s: 1.0 - solvers[s]["total"] / t0
                     for s in ("one_stage", "two_stage")}
    return out
