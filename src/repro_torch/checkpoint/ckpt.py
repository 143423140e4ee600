"""Fault-tolerant checkpointing: atomic, async-capable, in the reference's
on-disk format (`repro/checkpoint/ckpt.py`), so either package reads the
other's checkpoints.

Layout: <dir>/step_<N>/ containing one .npy per tree leaf, named by
flatten order (`leaf_00000.npy`), plus MANIFEST.json (step, the leaf key
-> file/shape/dtype map, and an optional verbatim `extra` dict).  Writes go
to a temp dir renamed into place - a crash mid-save never corrupts the
latest checkpoint - and restore cross-checks every loaded array against
the manifest's recorded shape/dtype, raising `CheckpointCorruptionError`
on any disagreement (a truncated or tampered leaf is never silently cast
into the target structure).

Leaf keys are the strings `jax.tree_util.keystr` gives the same tree, in
the reference's flatten order:

  * a dict key `k` is `[repr(k)]`, keys in sorted order (`['0']`);
  * a list or tuple index `i` is `[i]`, so a dict key "0" and an index 0
    are different leaves (a list-shaped checkpoint never restores into a
    dict-shaped tree);
  * a namedtuple field `f` is `.f`;
  * the plan classes flatten as the reference's pytree nodes do, each
    child `i` of their `tree_flatten` children as `[<flat index i>]`:
    `FinalizedPlan` (lu_stacks, mvm_levels, scale), `_MvmLevel` (stacks,
    divs) and `ArenaPlan` (stacks, scale, program);
  * None holds no leaf; anything else (a tensor, an array, a number) is a
    leaf.

`restore_checkpoint(..., device=...)` puts every restored leaf on one
device; `restore_checkpoint(..., sharding_tree=...)` lays each leaf out
with its *target* `NamedSharding` (`sharding/partition.py`) as a
DTensor, which is what makes elastic re-meshing (restore onto a mesh of
another shape) a pure restart-path operation.  A tree of DTensors saves
whole: every rank gathers each leaf (`full_tensor()`, a collective, so
every rank of the mesh calls `save_checkpoint`), rank 0 writes, and all
meet at a barrier before the call returns.  The manifest is the same, so
a sharded save restores unsharded and the other way round.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.core.blockamc import ArenaPlan, FinalizedPlan, _MvmLevel
from repro_torch.sharding.api import is_dtensor, lay_out

MANIFEST = "MANIFEST.json"

# the children of the plan classes, in the reference's tree_flatten order
_NODE_FIELDS = {
    FinalizedPlan: ("lu_stacks", "mvm_levels", "scale"),
    _MvmLevel: ("stacks", "divs"),
    ArenaPlan: ("stacks", "scale", "program"),
}


class CheckpointError(RuntimeError):
    """Base class for checkpoint-layer failures."""


class CheckpointCorruptionError(CheckpointError):
    """A leaf file disagrees with its manifest entry (shape/dtype/missing)."""


def _dict_order(d: dict) -> list:
    try:
        return sorted(d)
    except TypeError:
        return list(d)


def _children(node) -> Optional[list]:
    """[(key suffix, child)] of an inner node; None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in _dict_order(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", v) for f, v in zip(node._fields, node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    fields = _NODE_FIELDS.get(type(node))
    if fields is not None:
        return [(f"[<flat index {i}>]", getattr(node, f))
                for i, f in enumerate(fields)]
    return None


def flatten(tree) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs of `tree` in the reference's flatten order."""
    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            yield prefix, node
            return
        for suffix, child in kids:
            yield from walk(child, prefix + suffix)
    yield from walk(tree, "")


def tree_map_with_key(fn: Callable[[str, Any], Any], tree):
    """`tree` with each leaf replaced by fn(key, leaf), same structure."""
    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            return fn(prefix, node)
        new = [walk(child, prefix + suffix) for suffix, child in kids]
        if node is None:
            return None
        if isinstance(node, dict):
            return dict(zip(_dict_order(node), new))
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*new)
        if isinstance(node, (list, tuple)):
            return type(node)(new)
        return dataclasses.replace(
            node, **dict(zip(_NODE_FIELDS[type(node)], new)))
    return walk(tree, "")


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array; bfloat16 tensors, which numpy lacks,
    widened to float32 (exactly; either package's restore casts back to
    the target leaf's dtype); a DTensor gathered whole."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Blocking atomic save.  Returns the final checkpoint path.

    `extra` is an optional JSON-serializable dict stored verbatim in the
    manifest under "extra" - validation metadata (programming signatures,
    calibration thresholds) rides along with the arrays it describes.
    """
    final = os.path.join(directory, f"step_{step:08d}")
    leaves = list(flatten(tree))
    if any(is_dtensor(leaf) for _, leaf in leaves):
        # every rank gathers each leaf (in one order); rank 0 writes
        leaves = [(key, _host(leaf)) for key, leaf in leaves]
        if torch.distributed.get_rank() == 0:
            _write(final, leaves, step, extra)
        torch.distributed.barrier()
    else:
        _write(final, leaves, step, extra)
    return final


def _write(final: str, leaves, step: int, extra) -> None:
    os.makedirs(os.path.dirname(final) or ".", exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: Dict[str, Any] = {"step": step, "leaves": {}}
    if extra is not None:
        manifest["extra"] = extra
    for i, (key, leaf) in enumerate(leaves):
        arr = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def load_manifest(directory: str, step: int) -> Dict[str, Any]:
    """The raw manifest dict of one checkpoint (metadata-only read)."""
    path = os.path.join(directory, f"step_{step:08d}", MANIFEST)
    with open(path) as f:
        return json.load(f)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, MANIFEST)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, tree_like, device=None,
                       sharding_tree=None):
    """Restore into the structure of `tree_like`.

    Every leaf comes back as a tensor with its `tree_like` leaf's dtype
    and layout, on `device` when given, else on that leaf's device (the
    host for a non-tensor leaf).  `sharding_tree`: an optional tree of
    `NamedSharding`s matching `tree_like`; each leaf it names comes back
    as a DTensor laid out by it, on its mesh's device type (the elastic
    re-mesh path).  A DTensor leaf of `tree_like` with no sharding keeps
    its own mesh and placements.
    """
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    leaves_meta = manifest["leaves"]
    dev = None if device is None else torch.device(device)
    target = dict(flatten(sharding_tree)) if sharding_tree is not None \
        else {}

    def load(key, like):
        meta = leaves_meta.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        fpath = os.path.join(path, meta["file"])
        try:
            arr = np.load(fpath)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptionError(
                f"leaf {key!r}: cannot load {meta['file']}: {e}") from e
        if list(arr.shape) != list(meta["shape"]) or \
                str(arr.dtype) != meta["dtype"]:
            raise CheckpointCorruptionError(
                f"leaf {key!r}: file {meta['file']} is "
                f"{arr.dtype}{list(arr.shape)} but manifest recorded "
                f"{meta['dtype']}{meta['shape']}")
        if not isinstance(like, torch.Tensor):
            like = torch.from_numpy(np.asarray(like))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs {tuple(like.shape)}")
        sh = target.get(key)
        if sh is None and is_dtensor(like):
            mesh, place = like.device_mesh, like.placements
        elif sh is not None:
            mesh, place = sh.mesh, sh.placements
        else:
            # the like leaf's dtype and memory layout (a column-major LU
            # or inverse stays column-major, so a restored plan computes
            # the same bits as the one that was saved)
            out = torch.empty_like(like, device=dev)
            return out.copy_(torch.from_numpy(arr))
        on = dev if dev is not None else resolve_device(mesh.device_type)
        whole = torch.from_numpy(arr).to(dtype=like.dtype, device=on)
        return lay_out(whole, mesh, place)

    return tree_map_with_key(load, tree_like)


class CheckpointManager:
    """Async manager: save every k steps on a worker thread, keep last n.

    A tree of DTensors saves as `save_checkpoint` saves it: every rank
    calls `maybe_save` (and `wait`) at the same steps, all gather each
    leaf, rank 0 alone writes and collects old steps, and the next
    `wait` (which `maybe_save` makes first; a blocking save meets at
    once) holds every rank at a barrier until the write is done."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending_barrier = False

    def maybe_save(self, step: int, tree, blocking: bool = False) -> bool:
        if step % self.every != 0:
            return False
        self.wait()                      # meets, then raises an error
        sharded = any(is_dtensor(leaf) for _, leaf in flatten(tree))
        # Materialise on host *before* handing to the thread so training can
        # mutate device buffers immediately (snapshot semantics).
        host_tree = tree_map_with_key(lambda _, x: np.array(_host(x)), tree)
        self._pending_barrier = sharded
        if sharded and torch.distributed.get_rank() != 0:
            if blocking:
                self._meet()
            return True

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree)
                self._gc()
            except BaseException as e:   # surfaced on next maybe_save
                self._error = e

        if blocking:
            work()
            self._meet()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._meet()
        if self._error is not None:
            raise self._error

    def _meet(self):
        """The barrier a sharded save owes every rank, once."""
        if self._pending_barrier:
            self._pending_barrier = False
            torch.distributed.barrier()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
