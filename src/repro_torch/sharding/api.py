"""Activation-sharding policy: a scoped registry of named placements, as
`repro/sharding/api.py`.

Model code annotates tensors by *logical* name (`shard(x, "act_btd")`); a
launcher installs a policy binding those names to placements on its mesh.
With no policy installed every call is the identity, so unit tests and
single-device runs never touch a process group.  The language model's
real policy (`sharding/partition.make_policy` in the reference) is not
ported yet (ROADMAP.md queue 1, the language model's mesh), so a
policy's `meta` hints are read (`get_meta`), and a name it binds raises
in `shard`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass
class ShardingPolicy:
    mesh: Any                       # torch.distributed DeviceMesh
    rules: Dict[str, Any]           # logical name -> placement
    meta: Dict[str, int] = dataclasses.field(default_factory=dict)


_ACTIVE: Optional[ShardingPolicy] = None


def set_policy(policy: Optional[ShardingPolicy]) -> None:
    global _ACTIVE
    _ACTIVE = policy


def clear_policy() -> None:
    set_policy(None)


def current_policy() -> Optional[ShardingPolicy]:
    return _ACTIVE


@contextlib.contextmanager
def policy_scope(policy: ShardingPolicy):
    prev = current_policy()
    set_policy(policy)
    try:
        yield
    finally:
        set_policy(prev)


def shard(x: torch.Tensor, name: str) -> torch.Tensor:
    """x laid out by the active policy's rule for `name`: the identity
    with no policy or an unbound name; a bound name raises until the
    language model's mesh is ported."""
    pol = _ACTIVE
    if pol is None or pol.rules.get(name) is None:
        return x
    raise NotImplementedError(
        f"shard({name!r}): laying activations out on a mesh needs the "
        f"language model's mesh, not ported yet (ROADMAP.md queue 1)")


def get_meta(name: str, default: int = 1) -> int:
    """Integer hints from the active policy (e.g. dp_groups)."""
    pol = _ACTIVE
    if pol is None:
        return default
    return pol.meta.get(name, default)
