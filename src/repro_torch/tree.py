"""Nested-dict trees of tensors, the port's form of the reference's pytrees
of parameters, gradients and optimizer moments.

Leaves come in `jax.tree.leaves` order: dict keys sorted, depth first.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable, tree, *rest):
    """fn(leaf, *leaves of `rest` at the same key) over every leaf of the
    nested dict `tree`; the other trees share its keys."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> Iterator[Any]:
    """The leaves of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key])
    else:
        yield tree
