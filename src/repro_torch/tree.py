"""Nested dict/list trees of tensors: the port's stand-in for pytrees.

Parameters, gradients and optimizer state are plain nested dicts and lists
(the reference's pytrees).  Leaves are visited in JAX's order: dict keys
sorted, list items in order, so sums over the leaves and the checkpoint's
keys come out as the reference's do.  Anything that is not a dict, list or
tuple is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["tree_leaves", "tree_map", "tree_paths", "tree_unflatten"]


def _children(tree) -> list | None:
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_paths(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs in leaf order; a path is the tuple of dict
    keys and list indices from the root."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, sub in kids:
        yield from tree_paths(sub, prefix + (k,))


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` whose leaves, in leaf order, are
    ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of every
    tree in ``rest`` (same structure)."""
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(x) != len(leaves[0]) for x in leaves):
        raise ValueError("tree_map: trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])
