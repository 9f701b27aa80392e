"""Nested-dict trees of tensors: the port's counterpart of
``jax.tree_util`` for parameter and optimizer-state trees.

A tree is a dict whose values are trees or leaves; ``None`` marks an absent
leaf.  Leaves are visited in sorted key order, as ``jax.tree_util``
flattens dicts, so sums over leaves add in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["tree_items", "tree_leaves", "tree_map"]

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn(leaf, *leaves of rest at the same path)`` over ``tree``'s
    structure; a dict of ``rest`` may lack a key (its leaves are None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r.get(k) if isinstance(r, dict) else None
                                     for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree: PyTree, path: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in sorted key order, skipping None leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (str(k),))
    elif tree is not None:
        yield path, tree


def tree_leaves(tree: PyTree) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]
