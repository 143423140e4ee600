"""The readers of the program's spans and counters on the host, at the
program's host scale: a traced window read as if it ran on the card (the
spans then hold host times), the check of one step or request a window
item, and no reading where the run is on the host or the program has no
`tracing` module."""
import sys

import pytest
import torch

import core
import run
from window_trace import Tracer

SEED = 2 ** 31 + 91
READERS = {
    "stablelm-1.6b.train_4k": ("attn_core_share.train",
                               "optimizer_ms.train"),
    "glm4-9b.prefill_32k": ("attn_share.prefill", "ffn_share.prefill",
                            "kernel_build_s.prefill"),
}


def _window(cell_name):
    from repro_torch import tracing
    tracing.reset()
    cell = core.Cell(cell_name)
    ctx = run.build_context(cell, SEED, torch.device("cpu"), True)
    drv = cell.driver().Driver(ctx)
    drv.setup()
    tracer = Tracer(True, False)
    with tracer:
        items = drv.window(0.3, tracer.span)
    summary = tracer.summary()
    return lambda items=items, on_card=True: run.Run(
        items, 1.0, items[-1]["end"] - items[0]["start"], summary, 0,
        ctx.shapes, on_card)


@pytest.mark.parametrize("cell", sorted(READERS))
def test_readers_read_the_window_and_hold_one_root_an_item(cell,
                                                           monkeypatch):
    make = _window(cell)
    values = {m: core.reader(m).read(make()) for m in READERS[cell]}
    for name, value in values.items():
        unit = next(m["unit"] for m in core.load_spec()["per_layer"]
                    if m["name"] == name)
        if unit == "%":
            assert 0 < value <= 100, (name, value)
        elif name.startswith("kernel_build_s"):
            assert value == 0.0         # nothing built on the host
        else:
            assert value > 0, (name, value)
    # on the host, or without the program's tracing, no reading
    for name in READERS[cell]:
        assert core.reader(name).read(make(on_card=False)) is None
    items = make().items
    extra = dict(items[-1], start=items[-1]["end"] + 1,
                 end=items[-1]["end"] + 2)
    with pytest.raises(RuntimeError, match="one an item"):
        core.reader(READERS[cell][0]).read(make(items + [extra]))
    import repro_torch              # a program from before its tracing
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert core.reader(READERS[cell][0]).read(make()) is None
