"""The program's own spans and counters (`repro_torch.tracing`) over the
window of a traced run on the card, as the `program_span` and
`program_counter` readers read them.

`report(run, root)` is None where the run is untraced or on the host, or
where the program has no `tracing` module (a checkout from before it):
the metric is then left out of the line.  Otherwise it holds the spans
whose outermost span (the step or the request) started inside the
window, and it raises unless the window's every item holds exactly one
`root` span: a share over a denominator that counts another number of
steps or requests than the window is no share."""
from __future__ import annotations

from typing import Optional


def report(run, root: str) -> Optional[dict]:
    if run.trace is None or not run.on_card:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    rep = tracing.report(window=(run.items[0]["start"],
                                 run.items[-1]["end"]))
    starts = [] if rep is None else [r["start_s"] for r in rep["roots"]
                                     if r["name"] == root]
    held = [sum(i["start"] <= t <= i["end"] for t in starts)
            for i in run.items]
    if len(starts) != len(run.items) or set(held) != {1}:
        raise RuntimeError(
            f"{len(starts)} {root!r} spans over {len(run.items)} window "
            f"items (by item: {held}); the program opens one an item")
    return rep


def device_ms(rep: dict, *names: str) -> float:
    """The device ms of the spans `names`, summed over their calls."""
    return sum(rep["spans"][n]["device_ms"] for n in names
               if n in rep["spans"])
