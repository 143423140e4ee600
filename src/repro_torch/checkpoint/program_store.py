"""Durable programmed-state store for analog solvers, as in
`repro/checkpoint/program_store.py`, in its on-disk format.

Analog write-verify programming is the expensive, stochastic part of the
BlockAMC pipeline: partitioning, Schur complements, conductance mapping
with per-device noise, operator finalization and arena compilation.  A
`ProgramStore` persists the *result* of that work - the `FinalizedPlan`
and `ArenaPlan` of a `ProgrammedSolver` - through the atomic checkpoint
layer, so a replacement replica can reinstall conductance stacks from disk
instead of re-programming from scratch.

Validation is layered, cheapest first:

  1. identity:   the manifest records repr(plan_signature), a SHA-256 of
                 the host matrix bytes (float64), and a SHA-256 of the
                 program key's bytes (the reference's (2,) uint32 key,
                 `repro_torch.keys`).  A restore against a different
                 matrix, config, or key raises `StaleCheckpointError`
                 before any array is read.
  2. integrity:  the checkpoint layer cross-checks every leaf file
                 against its manifest shape/dtype
                 (`CheckpointCorruptionError`).
  3. physics:    the caller (the engine's install path) re-runs the canary
                 solve against the trip threshold *calibrated at original
                 program time* (stored in the manifest extra); a restored
                 plan that fails it raises `CheckpointRejectedError` and
                 falls back to full re-programming.

LU pivots are stored 0-based, as the reference's `lu_factor` gives them;
`torch.linalg.lu_factor`'s are 1-based, so `save` shifts them down and
`restore` shifts them back.  The digests, keys, shapes and dtypes are the
reference's too, so either package restores the other's store.

Restore needs a *template* solver of the same `plan_signature` to supply
the structure and static metadata: equal signatures mean identical
schedules, leaf shapes and layouts, so any surviving same-signature
replica is a valid template.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.ckpt import (CheckpointError, _host,
                                         latest_step, load_manifest,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.core.blockamc import ProgrammedSolver
from repro_torch.keys import as_key


class StaleCheckpointError(CheckpointError):
    """Checkpoint identity (signature / matrix hash / key) does not match."""


class CheckpointRejectedError(CheckpointError):
    """Restored plan failed post-restore validation (canary residual)."""


def _sanitize(matrix_id: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]", "_", matrix_id)


def _a_digest(a) -> str:
    arr = np.ascontiguousarray(np.asarray(_host(a), dtype=np.float64))
    return hashlib.sha256(arr.tobytes()).hexdigest()


def _key_digest(key) -> str:
    arr = np.ascontiguousarray(as_key(key))
    return hashlib.sha256(arr.tobytes()).hexdigest()


def _with_pivots(fin, shift: int):
    """`fin` with every LU pivot vector shifted by `shift`."""
    return dataclasses.replace(fin, lu_stacks=tuple(
        (lu, piv + shift) for lu, piv in fin.lu_stacks))


class ProgramStore:
    """Per-matrix atomic save/restore of programmed solver state.

    Layout: <root>/<matrix_id>/step_<N>/ via the checkpoint layer, one
    store per fleet (replicas share programmed state by construction: the
    fleet programs every matrix with the same key on every replica, so
    the stacks are bit-identical and any replica's save serves them all).
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._steps: Dict[str, int] = {}

    def _dir(self, matrix_id: str) -> str:
        return os.path.join(self.root, _sanitize(matrix_id))

    def has(self, matrix_id: str) -> bool:
        return latest_step(self._dir(matrix_id)) is not None

    def matrix_ids(self):
        if not os.path.isdir(self.root):
            return []
        return sorted(d for d in os.listdir(self.root)
                      if latest_step(os.path.join(self.root, d)) is not None)

    # -- save ---------------------------------------------------------------

    def save(self, matrix_id: str, solver, a, key, signature,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Persist a solver's programmed state with identity metadata.

        `extra` carries caller validation data (canary trip threshold,
        baseline residual) verbatim into the manifest.
        """
        meta = {
            "signature": repr(signature),
            "a_sha256": _a_digest(a),
            "key_sha256": _key_digest(key),
            "mode": solver.mode,
            "n": int(solver.n),
        }
        if extra:
            meta.update(extra)
        tree = {"fin": _with_pivots(solver.finalized, -1),
                "arena": solver.arena}
        with self._lock:
            step = self._steps.get(matrix_id)
            if step is None:
                prev = latest_step(self._dir(matrix_id))
                step = 0 if prev is None else prev + 1
            self._steps[matrix_id] = step + 1
        return save_checkpoint(self._dir(matrix_id), step, tree, extra=meta)

    # -- restore ------------------------------------------------------------

    def manifest(self, matrix_id: str) -> Dict[str, Any]:
        step = latest_step(self._dir(matrix_id))
        if step is None:
            raise CheckpointError(f"no checkpoint for {matrix_id!r}")
        return load_manifest(self._dir(matrix_id), step)

    def restore(self, matrix_id: str, template, a, key, signature,
                device=None) -> Tuple[Any, Dict[str, Any]]:
        """Rebuild a ProgrammedSolver from the latest checkpoint.

        `template` is any live same-signature ProgrammedSolver (e.g. from
        a surviving replica) supplying the structure and static metadata;
        the solver is rebuilt on `device` (default: the template's).
        Returns (solver, manifest_extra).  Raises StaleCheckpointError on
        identity mismatch, CheckpointCorruptionError on damaged files.
        The caller owns physics validation (canary vs stored trip).
        """
        directory = self._dir(matrix_id)
        step = latest_step(directory)
        if step is None:
            raise CheckpointError(f"no checkpoint for {matrix_id!r}")
        manifest = load_manifest(directory, step)
        meta = manifest.get("extra", {})
        if meta.get("signature") != repr(signature):
            raise StaleCheckpointError(
                f"{matrix_id!r}: checkpoint signature "
                f"{meta.get('signature')!r} != expected {repr(signature)!r}")
        if meta.get("a_sha256") != _a_digest(a):
            raise StaleCheckpointError(
                f"{matrix_id!r}: checkpoint was programmed from a different "
                f"matrix (hash mismatch)")
        if meta.get("key_sha256") != _key_digest(key):
            raise StaleCheckpointError(
                f"{matrix_id!r}: checkpoint was programmed with a different "
                f"key")
        like = {"fin": template.finalized, "arena": template.arena}
        tree = restore_checkpoint(directory, step, like,
                                  device=device or template.device)
        solver = ProgrammedSolver(_with_pivots(tree["fin"], 1),
                                  arena=tree["arena"], mode=template.mode)
        return solver, meta

    # -- damage hooks (tests / chaos) ---------------------------------------

    def corrupt(self, matrix_id: str, how: str = "values") -> str:
        """Deliberately damage the latest checkpoint (chaos / tests).

        how="values":   perturb every floating-point leaf in place, keeping
                        each file's shape and dtype - manifest-consistent,
                        so only the physics canary can catch it.  (Every
                        leaf, not "the largest": redundant plan forms like
                        the arena's whole-schedule `program` mean a
                        single-leaf hit can miss the stacks the executor
                        actually reads.)
        how="truncate": truncate the largest leaf file - caught by the
                        integrity layer as CheckpointCorruptionError.
        """
        directory = self._dir(matrix_id)
        step = latest_step(directory)
        if step is None:
            raise CheckpointError(f"no checkpoint for {matrix_id!r}")
        manifest = load_manifest(directory, step)
        cdir = os.path.join(directory, f"step_{step:08d}")
        if how == "truncate":
            biggest = max(manifest["leaves"].values(),
                          key=lambda m: int(np.prod(m["shape"] or [1])))
            fpath = os.path.join(cdir, biggest["file"])
            with open(fpath, "r+b") as f:
                f.truncate(max(0, os.path.getsize(fpath) // 2))
            return fpath
        if how != "values":
            raise ValueError(f"unknown corruption mode {how!r}")
        rng = np.random.default_rng(0)
        touched = None
        for meta in manifest["leaves"].values():
            fpath = os.path.join(cdir, meta["file"])
            arr = np.load(fpath)
            if not np.issubdtype(arr.dtype, np.floating) or arr.size == 0:
                continue
            noise = rng.normal(0.0, 1.0, size=arr.shape)
            np.save(fpath, (arr * 3.0 + arr.std() * noise +
                            1.0).astype(arr.dtype))
            touched = fpath
        if touched is None:
            raise CheckpointError(
                f"{matrix_id!r}: no floating-point leaf to corrupt")
        return touched
