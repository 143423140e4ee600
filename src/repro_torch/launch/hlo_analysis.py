"""Roofline accounting over the op trace of one rank, the counterpart of
`repro/launch/hlo_analysis.py`.

The reference walks the optimized, partitioned HLO text of a compiled
step.  PyTorch runs eagerly and has no HLO: this module walks the op
trace instead.  `OpAnalysis` is a `TorchDispatchMode`; every aten (or
custom) op that runs inside it is counted as it runs:

  flops            - `torch.utils.flop_counter`'s formula for the op (the
                     matrix products, attention, convolutions; a custom op
                     brings its own through `register_flop_formula`), the
                     numbers `FlopCounterMode` counts.  Elementwise ops
                     count no FLOPs, as in the reference.
  bytes            - operand bytes plus result bytes of each op.  Eager
                     mode fuses nothing, so every op is what the reference
                     calls an unfused top-level instruction.  Views and
                     metadata ops (`view`, `t`, `expand`, `slice`, ...) move
                     nothing and are skipped, as the reference skips
                     `bitcast` and `reshape`; so are allocations that write
                     nothing (`empty`).
  collective bytes - operand bytes of each collective, under the
                     reference's names: the functional collectives that
                     DTensor issues and the in-place c10d ones that
                     `torch.distributed` calls issue.

Per chip.  A dispatch mode runs before DTensor's own dispatch, so it would
see each op of a sharded tensor at its global shape, the whole mesh's
work.  `OpAnalysis` hands any op with a DTensor argument back
(`NotImplemented`, as `CommDebugMode` does): DTensor then runs it as ops
on this rank's local shards plus the collectives its placements need, and
the mode counts those.  The shapes DTensor propagates through a fake copy
of an op to learn its output's global shape are not work and are not
counted (`sharding.api.shape_propagation`).

Loops.  The reference multiplies a while body by its trip count.  Eager
mode runs each layer, each microbatch and each recomputation as it
happens, so each is counted as often as it runs, and there are no trip
counts to infer.

Memory.  The mode also tracks the storages its ops create while they live
(a fake tensor's storage allocates nothing, but has its size): `peak_bytes`
is the most live at once beyond the arguments registered with `hold`, and
`peak_live` the largest of the storages live at that moment (`PEAK_LIVE`
of them), each with its bytes, the dtype and shape of the tensor that
created it and the op that did - the breakdown of a peak.  A
collective's wait hands back the collective's own result: its result
counts as that storage (a fake tensor's wait makes a second one).
"""
from __future__ import annotations

import contextlib
import heapq
import weakref
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.sharding.api import is_dtensor_type, shape_propagation

PEAK_LIVE = 8       # storages listed at the peak (`OpAnalysis.peak_live`)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")

_F = "_c10d_functional."
# op -> (reference name, index of the operand argument)
_COLLECTIVE_OPS = {
    _F + "all_reduce": ("all-reduce", 0),
    _F + "all_reduce_": ("all-reduce", 0),
    _F + "all_reduce_coalesced": ("all-reduce", 0),
    _F + "all_reduce_coalesced_": ("all-reduce", 0),
    _F + "all_gather_into_tensor": ("all-gather", 0),
    _F + "all_gather_into_tensor_out": ("all-gather", 0),
    _F + "all_gather_into_tensor_coalesced": ("all-gather", 0),
    _F + "reduce_scatter_tensor": ("reduce-scatter", 0),
    _F + "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    _F + "all_to_all_single": ("all-to-all", 0),
    "_dtensor.shard_dim_alltoall": ("all-to-all", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
    "c10d.recv_": ("collective-permute", 0),
}

# Ops that move no bytes beside the views (`OpOverload.is_view`):
# views without the alias annotation, metadata, allocation without a
# write, and the wait of a collective (counted at its start, as the
# reference counts `-start` and not `-done`).
_NO_BYTES = {
    "aten._unsafe_view", "aten.alias", "aten.detach", "aten.lift_fresh",
    "aten.empty", "aten.empty_like", "aten.empty_strided", "aten.sym_size",
    "aten.sym_stride", "aten.sym_numel", "aten.sym_storage_offset",
    "aten.is_contiguous", "aten.is_same_size", "aten.is_nonzero",
    "aten._local_scalar_dense", "aten.set_", "prim.device", "prim.layout",
    _F + "wait_tensor",
}


def _overloads(*names):
    """The overloads "namespace.op.overload" this torch release has."""
    out = set()
    for name in names:
        space, op, overload = name.split(".")
        packet = getattr(getattr(torch.ops, space), op, None)
        if packet is not None and hasattr(packet, overload):
            out.add(getattr(packet, overload))
    return out


# The ops `FlopCounterMode` hands back without counting or decomposing.
_FLOP_SKIP = _overloads(
    "aten.sym_is_contiguous.default", "aten.is_contiguous.default",
    "aten.is_contiguous.memory_format",
    "aten.is_strides_like_format.default",
    "aten.is_non_overlapping_and_dense.default", "aten.size.default",
    "aten.sym_size.default", "aten.stride.default", "aten.sym_stride.default",
    "aten.storage_offset.default", "aten.sym_storage_offset.default",
    "aten.numel.default", "aten.sym_numel.default", "aten.dim.default",
    "prim.layout.default")


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a tensor (a DTensor: its local shard) views."""
    if is_dtensor_type(type(t)):
        t = t.to_local()
    return t.numel() * t.element_size()


def tensors(tree) -> List[torch.Tensor]:
    """The tensors among the leaves of a pytree (DTensors included)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        out = []
        for x in tree:      # an op's arguments: a flat walk is enough
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple, dict)):
                out.extend(tensors(x))
        return out
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


_DECOMPOSES: Dict[Any, bool] = {}


def _decomposes(func) -> bool:
    """Whether `func` has a decomposition `OpOverload.decompose` would run
    (a CompositeImplicitAutograd kernel), which `FlopCounterMode` runs in
    place of an op it has no formula for."""
    got = _DECOMPOSES.get(func)
    if got is None:
        key = torch._C.DispatchKey.CompositeImplicitAutograd
        got = _DECOMPOSES[func] = (
            isinstance(func, torch._ops.OpOverload)
            and func is not torch.ops.prim.device.default
            and (key in func.py_kernels
                 or torch._C._dispatch_has_kernel_for_dispatch_key(
                     func.name(), key)))
    return got


def _type_str(out) -> str:
    """The reference's result-type token, e.g. "bf16[16,4096]", of an op's
    first tensor result."""
    ts = tensors(out)
    if not ts:
        return ""
    t = ts[0]
    short = {torch.float32: "f32", torch.bfloat16: "bf16",
             torch.float16: "f16", torch.float64: "f64",
             torch.int32: "s32", torch.int64: "s64", torch.bool: "pred",
             torch.uint8: "u8", torch.int8: "s8"}
    name = short.get(t.dtype, str(t.dtype).replace("torch.", ""))
    return f"{name}[{','.join(str(d) for d in t.shape)}]"[:48]


class OpAnalysis(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and live memory of the ops run
    inside it, on this rank's local tensors (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: Dict[str, float] = {}
        self.flops_by_op: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.coll = {c: {"count": 0.0, "bytes": 0.0} for c in COLLECTIVES}
        self.warnings: List[str] = []
        self._instrs: Dict[tuple, list] = {}
        self._shadow = 0
        self._hooks: list = []
        # live storages: key -> [bytes, references, (dtype, shape, op),
        # the keys aliased to it]; the keys of a wait's results, each
        # aliased to its collective's; the arguments' keys
        self._live: Dict[int, list] = {}
        self._alias: Dict[int, int] = {}
        self._held: set = set()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._peak_live: List[list] = []

    # -- memory -----------------------------------------------------------

    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def hold(self, tree) -> int:
        """Register the tensors of `tree` (DTensors by their local shards)
        as arguments: their storages are not temporaries.  Returns their
        bytes."""
        total = 0
        for t in tensors(tree):
            local = t.to_local() if is_dtensor_type(type(t)) else t
            self._held.add(self._key(local))
            total += tensor_bytes(local)
        return total

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            self.live_bytes -= entry[0]
            del self._live[key]
            for alias in entry[3]:
                self._alias.pop(alias, None)

    def _track(self, out, inputs, name: str) -> None:
        seen = {id(x) for x in inputs}
        ts = tensors(out)
        if name == _F + "wait_tensor" and ts and inputs:
            # the wait hands back the collective's own result; a fake
            # tensor's wait allocates a second storage, which would count
            # every gathered tensor twice
            own = self._key(inputs[0])
            own = self._alias.get(own, own)
            entry = self._live.get(own)
            if entry is not None:
                key = self._key(ts[0])
                if key != own:
                    self._alias[key] = own
                    entry[3].append(key)
                entry[1] += 1
                weakref.finalize(ts[0], self._release, own)
                return
        for t in ts:
            if id(t) in seen:
                continue
            key = self._key(t)
            key = self._alias.get(key, key)
            if key in self._held:
                continue
            entry = self._live.get(key)
            if entry is None:
                entry = self._live[key] = [t.untyped_storage().nbytes(), 0,
                                           (t.dtype, tuple(t.shape), name),
                                           []]
                self.live_bytes += entry[0]
                if self.live_bytes > self.peak_bytes:
                    self.peak_bytes = self.live_bytes
                    self._peak_live = heapq.nlargest(
                        PEAK_LIVE, self._live.values(), key=lambda e: e[0])
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def peak_live(self) -> List[Dict[str, Any]]:
        """The largest storages live at the peak, largest first: bytes,
        the dtype and shape of the tensor that created each, and the op
        that created it."""
        return [{"bytes": e[0], "dtype": str(e[2][0]).replace("torch.", ""),
                 "shape": list(e[2][1]), "op": e[2][2]}
                for e in self._peak_live]

    # -- the trace --------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(is_dtensor_type(t) for t in types):
            return NotImplemented
        if self._shadow:
            return func(*args, **kwargs)
        if func in _FLOP_SKIP:
            return NotImplemented
        if _decomposes(func):
            # what FlopCounterMode does with an op it has no formula for
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self._count(func, out, args, kwargs)
        return out

    @contextlib.contextmanager
    def shadow(self):
        """A context in which ops run uncounted (DTensor's shape
        propagation)."""
        self._shadow += 1
        try:
            yield
        finally:
            self._shadow -= 1

    def _count(self, func, out, args, kwargs) -> None:
        packet = func._overloadpacket
        name = str(packet)
        self.calls[name] = self.calls.get(name, 0) + 1
        formula = flop_registry.get(packet)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
            self.flops += flops
            if flops:
                what = f"{name} {_type_str(out)}"
                self.flops_by_op[what] = self.flops_by_op.get(what, 0.0) + \
                    flops
        elif func.namespace not in ("aten", "prim", "c10d",
                                    "_c10d_functional", "_dtensor"):
            msg = f"{name}: no FLOP formula, counted as 0"
            if msg not in self.warnings:
                self.warnings.append(msg)
        inputs = tensors(args) + (tensors(list(kwargs.values()))
                                  if kwargs else [])
        coll = _COLLECTIVE_OPS.get(name)
        if coll is not None:
            kind, index = coll
            moved = sum(tensor_bytes(t) for t in tensors(args[index]))
            self.coll[kind]["count"] += 1
            self.coll[kind]["bytes"] += moved
        elif name.startswith(("c10d.", _F)) and name not in _NO_BYTES:
            msg = f"{name}: a collective the reference does not name"
            if msg not in self.warnings:
                self.warnings.append(msg)
        if not (func.is_view or name in _NO_BYTES or coll is not None):
            moved = sum(tensor_bytes(t) for t in inputs) + \
                sum(tensor_bytes(t) for t in tensors(out))
            if moved:
                self.bytes += moved
                self.by_op[name] = self.by_op.get(name, 0.0) + moved
                slot = self._instrs.setdefault((name, _type_str(out)),
                                               [0.0, 0])
                slot[0] += moved
                slot[1] += 1
        self._track(out, inputs, name)

    def __enter__(self):
        hook = shape_propagation(self.shadow)
        hook.__enter__()
        self._hooks.append(hook)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._hooks.pop().__exit__(*exc)

    def result(self) -> Dict[str, Any]:
        """The reference's keys: flops, bytes, by_op, top_instrs,
        collectives, collective_bytes, warnings; and flops_by_op, the
        FLOPs of each op and result type, the largest 16."""
        top = sorted(self._instrs.items(), key=lambda kv: -kv[1][0])[:16]
        return {
            "flops": self.flops, "bytes": self.bytes,
            "by_op": dict(sorted(self.by_op.items(),
                                 key=lambda kv: -kv[1])[:12]),
            "top_instrs": [
                {"gbytes": round(b / 1e9, 2), "op": op, "type": t,
                 "comp": "trace", "mult": n}
                for (op, t), (b, n) in top],
            "collectives": {c: dict(v) for c, v in self.coll.items()},
            "collective_bytes": sum(v["bytes"] for v in self.coll.values()),
            "warnings": list(self.warnings),
            "flops_by_op": dict(sorted(self.flops_by_op.items(),
                                       key=lambda kv: -kv[1])[:16]),
        }


def analyze(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run fn(*args, **kwargs) inside an `OpAnalysis` and return its
    result (`OpAnalysis.result`), with `peak_bytes`: the most bytes live
    at once beyond the arguments, and `peak_live`: the largest storages
    live then."""
    acc = OpAnalysis()
    acc.hold((args, kwargs))
    with acc:
        fn(*args, **kwargs)
    out = acc.result()
    out["peak_bytes"] = acc.peak_bytes
    out["peak_live"] = acc.peak_live()
    return out
