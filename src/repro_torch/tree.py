"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

Params, optimizer state and checkpoint bundles are nested dicts.  Leaves
are visited in sorted-key order, the order ``jax.tree_util`` flattens
dicts in, and ``None`` is an empty subtree, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves_with_paths(tree: Any, prefix: tuple[str, ...] = ()
                      ) -> list[tuple[tuple[str, ...], Any]]:
    """(key path, leaf) pairs in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def from_paths(pairs) -> dict:
    """Inverse of ``leaves_with_paths`` for a tree of nested dicts."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
