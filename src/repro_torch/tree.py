"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

Params, optimizer state and checkpoint bundles are nested dicts.  Leaves
are visited in sorted-key order, the order ``jax.tree_util`` flattens
dicts in, and ``None`` is an empty subtree, as in JAX.  A ``Node`` (a
tensor laid out on a mesh, ``distributed.sharding.Placed``) is a subtree
whose leaves are its blocks, as a registered pytree node is in JAX; an
``is_leaf`` predicate stops the walk at it.
"""
from __future__ import annotations

from typing import Any, Callable


class Node:
    """A container the tree functions walk into: ``children()`` maps
    sortable keys to subtrees, ``rebuild(children)`` makes a node of the
    same kind around new ones (each of the same shape)."""

    def children(self) -> dict:
        raise NotImplementedError

    def rebuild(self, children: dict) -> "Node":
        raise NotImplementedError


def leaves_with_paths(tree: Any, prefix: tuple[str, ...] = (), *,
                      is_leaf: Callable[[Any], bool] | None = None
                      ) -> list[tuple[tuple[str, ...], Any]]:
    """(key path, leaf) pairs in JAX's flatten order; a ``Node``'s child
    adds ``str(key)`` to the path."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], prefix + (k,),
                                     is_leaf=is_leaf)
        return out
    if isinstance(tree, Node):
        kids = tree.children()
        out = []
        for k in sorted(kids):
            out += leaves_with_paths(kids[k], prefix + (str(k),),
                                     is_leaf=is_leaf)
        return out
    return [(prefix, tree)]


def leaves(tree: Any, *, is_leaf: Callable[[Any], bool] | None = None
           ) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf=is_leaf)]


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); a subtree for which
    ``is_leaf`` holds is passed to ``fn`` whole."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf)
                for k in tree}
    if isinstance(tree, Node):
        others = [r.children() for r in rest]
        return tree.rebuild({k: tree_map(fn, c, *(o[k] for o in others),
                                         is_leaf=is_leaf)
                             for k, c in tree.children().items()})
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
