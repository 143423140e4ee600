"""Spans and counters inside the program, kept while a torch profiler
records.

`span(name)` marks a stretch of the program's work.  With no profiler
recording (`torch.autograd.profiler._is_profiler_enabled` false) it
returns one shared null context and nothing else runs: no
`record_function`, no event, no allocation.  While one records, a span

- opens a profiler range named `name` (the `RecordFunction` that
  `torch.profiler.record_function` opens through an operator, here
  opened directly: `torch._C._profiler._RecordFunctionFast`, so that no
  dispatch mode, such as a selective checkpoint's, sees it), so it
  stands in the profiler's trace on the clock of the device's events
  (an idle gap of the device is then named by the innermost span open
  at its middle);
- records a pair of CUDA timing events on the current stream where CUDA
  is initialised (else reads `time.perf_counter_ns`), and the host's
  `time.perf_counter` at its start and end;
- keeps its name, its parent and its outermost span in memory until
  `reset()`.  The parent is the innermost span open on the same thread;
  a span opened on an autograd engine's thread with none open there
  takes the innermost span of the thread that opened the latest
  outermost span (the one waiting on the backward).  The outermost span
  is the step or the request: the spans of one share it.

A span opened while the autograd engine runs a backward
(`torch._C._current_graph_task_id() != -1`) is forward work recomputed
there by a checkpoint (`torch.utils.checkpoint`) and takes the suffix
".recompute", so that the recompute is counted once, under its own name.

`backward_span(name, inputs, output)` times the backward of the work
between `inputs` and `output` with gradient hooks, which add no node to
the graph and leave every gradient as it is: the output's hook opens the
span `name` and the first input's hook closes it.  The engine runs the
nodes that are ready in reverse order of creation, so the work's
backward nodes, all made after the inputs' own, have all run before an
input's hook.  Without a profiler recording, and in a checkpoint's
recompute (whose graph no backward runs), it registers nothing.

`count(name, n)` keeps counters for the life of the process, whether a
profiler records or not.  `report()` synchronises the card and sums the
spans by name (calls, device ms: the stream's time between the span's
two events, the host's where it ran on the host; self ms: less its child
spans'), with the outermost spans, which span nests in which, and the
counters.  `reset()` clears spans and counters.  Nothing is written
out: the benchmark's readers call `report()`.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _profiler

RECOMPUTE = ".recompute"
_NULL = contextlib.nullcontext()


class _State:
    """The process's spans and counters (one per process: the spans of
    every thread of a step have to meet in one place)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: List["_Record"] = []
        self.counters: Dict[str, float] = {}
        self.local = threading.local()
        self.outer: Optional[list] = None   # the stack of the latest root

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_STATE = _State()


def _mark():
    if not torch.cuda.is_initialized():
        return time.perf_counter_ns()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class _Record:
    """One span, entered as a context: its name, parent and outermost
    records, the host's perf_counter seconds at both ends, its two marks
    (CUDA events or perf_counter_ns readings) and the profiler's handle
    of its range."""
    __slots__ = ("name", "in_backward", "parent", "root", "t0", "t1", "m0",
                 "m1", "handle")

    def __init__(self, name: str, in_backward: bool = False):
        self.name, self.in_backward = name, in_backward
        self.t1 = self.m1 = None

    def __enter__(self):
        stack = _STATE.stack()
        engine = torch._C._current_graph_task_id() != -1
        if engine and not self.in_backward:
            self.name += RECOMPUTE
        parent = stack[-1] if stack else None
        if parent is None and engine and _STATE.outer:
            parent = _STATE.outer[-1]
        if parent is None and not engine:
            _STATE.outer = stack
        self.parent = parent
        self.root = self if parent is None else parent.root
        self.handle = torch._C._profiler._RecordFunctionFast(self.name)
        self.handle.__enter__()
        self.t0 = time.perf_counter()
        self.m0 = _mark()
        stack.append(self)
        with _STATE.lock:
            _STATE.records.append(self)
        return self

    def __exit__(self, *exc):
        self.m1 = _mark()
        self.t1 = time.perf_counter()
        self.handle.__exit__(None, None, None)
        self.handle = None
        stack = _STATE.stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        return False


def span(name: str):
    """A context that marks its body as the span `name` while a profiler
    records, and does nothing otherwise (module docstring)."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Record(name)


class _Pending:
    """One backward span: its hooks open it at the output's gradient and
    close it at the first input's.  A hook returns None, so the gradient
    passes unchanged."""
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name, self.rec = name, None

    def open(self, grad):
        if self.rec is None and _profiler._is_profiler_enabled:
            self.rec = _Record(self.name, in_backward=True).__enter__()

    def close(self, grad):
        if self.rec is not None:
            self.rec.__exit__(None, None, None)
            self.rec = None


def backward_span(name: str, inputs: Sequence[torch.Tensor],
                  output: torch.Tensor) -> None:
    """Makes the backward of the work from `inputs` to `output` the span
    `name` (module docstring); does nothing without a profiler recording,
    where autograd records through no input, or in a checkpoint's
    recompute."""
    if not (_profiler._is_profiler_enabled and output.requires_grad
            and any(t.requires_grad for t in inputs)
            and torch._C._current_graph_task_id() == -1):
        return
    pending = _Pending(name)
    output.register_hook(pending.open)
    for t in inputs:
        if t.requires_grad:
            t.register_hook(pending.close)


def count(name: str, n: float = 1) -> None:
    """Adds n to the process's counter `name`."""
    with _STATE.lock:
        _STATE.counters[name] = _STATE.counters.get(name, 0) + n


def _elapsed_ms(rec: _Record) -> float:
    a, b = rec.m0, rec.m1
    if isinstance(a, int) and isinstance(b, int):
        return (b - a) / 1e6
    if isinstance(a, torch.cuda.Event) and isinstance(b, torch.cuda.Event):
        return a.elapsed_time(b)
    return (rec.t1 - rec.t0) * 1e3      # CUDA started inside the span


def report(window: Optional[Tuple[float, float]] = None) -> Optional[dict]:
    """None where no span ended and no counter counted; else
    {"spans": {name: {"calls", "device_ms", "self_ms"}}, "roots": [{"name",
    "start_s", "end_s", "device_ms"}] (the outermost spans in order),
    "nesting": [(span, its parent's name)], "counters": {name: value}}.
    `window` (host perf_counter seconds) keeps the outermost spans that
    started inside it, and theirs.  Spans of an outermost span still
    open are left out."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    with _STATE.lock:
        records = list(_STATE.records)
        counters = dict(_STATE.counters)
    roots = [r for r in records if r.parent is None and r.m1 is not None]
    if not roots and not counters:
        return None
    if window is not None:
        roots = [r for r in roots if window[0] <= r.t0 <= window[1]]
    kept = {id(r) for r in roots}
    ms = {id(r): _elapsed_ms(r) for r in records
          if id(r.root) in kept and r.m1 is not None}
    children: Dict[int, float] = defaultdict(float)
    for r in records:
        if id(r) in ms and r.parent is not None:
            children[id(r.parent)] += ms[id(r)]
    spans: Dict[str, dict] = {}
    nesting = set()
    for r in records:
        if id(r) not in ms:
            continue
        s = spans.setdefault(r.name, {"calls": 0, "device_ms": 0.0,
                                      "self_ms": 0.0})
        s["calls"] += 1
        s["device_ms"] += ms[id(r)]
        s["self_ms"] += ms[id(r)] - children[id(r)]
        if r.parent is not None:
            nesting.add((r.name, r.parent.name))
    return {"spans": spans,
            "roots": [{"name": r.name, "start_s": r.t0, "end_s": r.t1,
                       "device_ms": ms[id(r)]}
                      for r in sorted(roots, key=lambda r: r.t0)],
            "nesting": sorted(nesting), "counters": counters}


def reset() -> None:
    """Forgets every span and counter (call it with no span open)."""
    with _STATE.lock:
        _STATE.records = []
        _STATE.counters.clear()
        _STATE.outer = None
