"""Gradient-based calibration of the analog substrate's physics knobs, as
in `repro/calib/`: `wire` recovers a planted wire segment resistance by
matching the differentiable first-order wire model against the exact
nodal oracle."""
from repro_torch.calib.wire import (  # noqa: F401
    WireCalibration, calibrate_wire, calibrate_wire_to)
