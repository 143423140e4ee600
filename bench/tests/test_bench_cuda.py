"""The harness on the card, at the program's host scale (the cells' own
sizes run through `bench/run.py` itself).  Each test decides inside
itself whether there is a card and skips without one."""
import pytest
import torch

import core
import run

CELLS = [w["name"] for w in core.load_spec()["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_on_the_card(cell):
    _card()
    out = run.run_cell(cell, 2 ** 31 + 5, 0.5, True, "cuda", host_scale=True)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    want = {m["name"] for m in core.Cell(cell).per_layer}
    got = set(out["metrics"])
    # host scale runs the float32 kernel; the shares stay within the peak
    assert got <= want and {n for n in want if n.startswith(
        ("idle_pct", "peak_gb"))} <= got
    for name, m in out["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 105, (name, m)
