"""The traced run's reduction: `torch.profiler` over the measured window,
reduced to the device's busy time (the union of its kernel, copy and
fill intervals inside the window), each kernel's device time by name,
the operators with the most device time of their own, and the longest
idle gaps named by what the host was doing in them (the innermost host
span or operator open at the gap's middle).
"""
from __future__ import annotations

import bisect
import contextlib
import gc
from collections import defaultdict

import torch

WINDOW_SPAN = "bench.window"
# CUPTI's mark of a launch that waited for room in the card's queue: it
# carries the launching operator's correlation id, but names no operator
BUFFER_FULL = "Command Buffer Full"
TOP = 10


class Tracer:
    """A context over the window: profiles it when `on`, else does
    nothing.  `span(name)` marks a stretch of the benchmark's own host
    work in the trace."""

    def __init__(self, on: bool, device_activity: bool):
        self.on = on
        self.prof = None
        if on:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if device_activity:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def __enter__(self):
        if self.on:
            self.prof.__enter__()
            self._window = torch.profiler.record_function(WINDOW_SPAN)
            self._window.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            self._window.__exit__(*exc)
            self.prof.__exit__(*exc)
        return False

    def summary(self) -> dict:
        """{"busy_s", "window_s", "kernels": {name: s}, "device_ops":
        [[op, s]], "idle_gaps": [[host activity, s]]}; busy_s is 0 where
        the trace holds no device event.  Read from the profiler's raw
        events: a kernel names the operator that launched it by its
        linked correlation id."""
        dev_type = torch.autograd.DeviceType
        ops_by_id, host, dev = {}, [], []
        w0 = w1 = None
        for e in self.prof.profiler.kineto_results.events():
            kind = e.device_type()
            if kind == dev_type.CPU:
                if e.linked_correlation_id() == 0:  # an operator or a span
                    name = e.name()
                    if name != BUFFER_FULL:
                        ops_by_id[e.correlation_id()] = name
                    host.append((e.start_ns(), e.end_ns(), name))
                    if name == WINDOW_SPAN:
                        w0, w1 = e.start_ns(), e.end_ns()
            elif kind == dev_type.CUDA and not (
                    e.is_user_annotation() or e.name().startswith("bench.")):
                dev.append((e.start_ns(), e.end_ns(), e.name(),
                            e.linked_correlation_id()))
        if w0 is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
        kernels, ops = defaultdict(float), defaultdict(float)
        spans = []
        for a, b, name, op in dev:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                kernels[name] += (b - a) / 1e9
                ops[ops_by_id.get(op, "(no operator)")] += (b - a) / 1e9
                spans.append((a, b))
        spans.sort()
        busy, gaps, end = 0, [], w0
        for a, b in spans:
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if spans and w1 > end:
            gaps.append((end, w1))
        out = {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
               "kernels": dict(kernels), "device_ops": _top(ops),
               "idle_gaps": _top(_name_gaps(gaps, host)) if spans else []}
        self.prof = None
        gc.collect()
        return out


def _top(totals: dict):
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
            [:TOP]]


def _name_gaps(gaps, host) -> dict:
    """Seconds of idle device time by the innermost host event open at
    each gap's middle: of nested events, the latest to start (the longest
    5000 gaps; the rest are summed as "(shorter gaps)")."""
    host = sorted(host)
    starts = [a for a, _, _ in host]
    totals = defaultdict(float)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    for a, b in gaps[:5000]:
        mid = (a + b) / 2
        name = "(no host event)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 20000, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        totals[name] += (b - a) / 1e9
    rest = sum(b - a for a, b in gaps[5000:])
    if rest:
        totals["(shorter gaps)"] += rest / 1e9
    return totals


def idle_pct(summary) -> float | None:
    """The idle share of a traced window, in percent; None where the trace
    holds no device event."""
    if summary is None or summary["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
