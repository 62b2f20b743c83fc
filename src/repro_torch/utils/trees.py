"""Parameter trees of dicts and lists, flattened in JAX's leaf order.

``jax.tree.flatten`` visits dict keys in sorted order and list items in
index order; the port keeps that order because the int4 wire folds its
rounding noise per *leaf index* (the reference's
``compression.encode_tree``), so the order is part of the wire contract.
A tree is a dict or a list whose values are trees or leaves (the
RecurrentGemma hybrid holds a list of per-layer dicts); a tree of
per-leaf payload dicts is read back with :func:`flatten_up_to`.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any
Treedef = Any


def _children(t):
    """``(key, child)`` pairs of a dict (sorted keys) or a list."""
    return sorted(t.items()) if isinstance(t, dict) else enumerate(t)


# The recursions below are module-level functions that take their
# accumulator as an argument: a nested function that calls itself is a
# reference cycle, which would keep every leaf it collected alive until
# the garbage collector runs (gigabytes, for a model's layers).

def _flatten(t, leaves: List[Any]):
    if isinstance(t, dict):
        return {k: _flatten(t[k], leaves) for k in sorted(t)}
    if isinstance(t, list):
        return [_flatten(x, leaves) for x in t]
    leaves.append(t)
    return None


def tree_flatten(tree: Tree) -> Tuple[List[Any], Treedef]:
    """Leaves in JAX's depth-first order, plus a structure token."""
    leaves: List[Any] = []
    treedef = _flatten(tree, leaves)
    return leaves, treedef


def _unflatten(d, it):
    if d is None:
        return next(it)
    if isinstance(d, list):
        return [_unflatten(v, it) for v in d]
    return {k: _unflatten(v, it) for k, v in d.items()}


def tree_unflatten(treedef: Treedef, leaves: List[Any]) -> Tree:
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def _up_to(d, t, out: List[Any]) -> None:
    if d is None:
        out.append(t)
    else:
        for k, v in _children(d):
            _up_to(v, t[k], out)


def flatten_up_to(treedef: Treedef, tree: Tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``treedef`` (e.g.
    one payload dict per parameter leaf), in leaf order."""
    out: List[Any] = []
    _up_to(treedef, tree, out)
    return out


def tree_leaves(tree: Tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over matching leaves of ``tree`` and ``rest`` (same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
