"""Nested-dict parameter trees, flattened in JAX's leaf order.

``jax.tree.flatten`` visits dict keys in sorted order; the port keeps that
order because the int4 wire folds its rounding noise per *leaf index*
(the reference's ``compression.encode_tree``), so the order is part of the
wire contract.  A tree is a dict whose values are dicts or leaves; a tree
of per-leaf payload dicts is read back with :func:`flatten_up_to`.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any
Treedef = Any


def tree_flatten(tree: Tree) -> Tuple[List[Any], Treedef]:
    """Leaves in sorted-key depth-first order, plus a structure token."""
    leaves: List[Any] = []

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(t[k]) for k in sorted(t)}
        leaves.append(t)
        return None

    return leaves, rec(tree)


def tree_unflatten(treedef: Treedef, leaves: List[Any]) -> Tree:
    it = iter(leaves)

    def rec(d):
        if d is None:
            return next(it)
        return {k: rec(v) for k, v in d.items()}

    out = rec(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def flatten_up_to(treedef: Treedef, tree: Tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``treedef`` (e.g.
    one payload dict per parameter leaf), in leaf order."""
    out: List[Any] = []

    def rec(d, t):
        if d is None:
            out.append(t)
        else:
            for k, v in d.items():
                rec(v, t[k])

    rec(treedef, tree)
    return out


def tree_leaves(tree: Tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over matching leaves of ``tree`` and ``rest`` (same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
