"""Nested dicts of tensors, the port's counterpart of the JAX package's
pytrees of params, gradients and optimizer state: map over the leaves, and
walk them in ``jax.tree_util``'s order (dict keys sorted)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same nesting), as ``jax.tree_util.tree_map``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> Iterator[Any]:
    """The leaves in the JAX package's order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_paths(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) in the JAX package's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], path + (k,))
    else:
        yield path, tree


def tree_pick(tree, i: int):
    """The ``i``-th element of every tuple leaf."""
    if isinstance(tree, dict):
        return {k: tree_pick(v, i) for k, v in tree.items()}
    return tree[i]


def tree_from_paths(items) -> dict:
    """The nested dict of ``(key path, leaf)`` pairs (``tree_paths``'s
    inverse)."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
