"""Tree-level push-payload encoding with error feedback (the reference's
``dist/compression.py:encode_tree`` / ``decode_tree``).

    eff           = tree + error          (error defaults to zeros)
    payloads      = encode(eff)           per leaf
    reconstructed = decode(payloads)      what the receiver sees
    new_error     = eff - reconstructed

The caller keeps ``new_error`` and folds it into the next push, so the
compression bias telescopes over rounds (Karimireddy et al., 2019).
Stochastic formats (int4) draw leaf ``i``'s noise under the key
``(round_step, i)``, ``i`` in the reference's leaf order.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.dist.wire import NoiseFn, get_format
from repro_torch.utils.trees import (
    flatten_up_to, tree_flatten, tree_map, tree_unflatten,
)

Tree = Any


def encode_tree(tree: Tree, mode: str, error: Optional[Tree] = None, *,
                round_step: int = 0, noise: Optional[NoiseFn] = None,
                with_residual: bool = True
                ) -> Tuple[Tree, Optional[Tree], Optional[Tree]]:
    """Returns ``(payloads, reconstructed, new_error)``; the last two are
    None with ``with_residual=False`` (nothing is decoded then)."""
    fmt = get_format(mode)
    eff = tree if error is None else tree_map(lambda a, b: a + b, tree, error)
    leaves, treedef = tree_flatten(eff)
    payloads, rec, err = [], [], []
    for i, leaf in enumerate(leaves):
        p = fmt.encode(leaf, key=(round_step, i), noise=noise)
        payloads.append(p)
        if with_residual:
            r = fmt.decode(p, leaf.shape, leaf.dtype)
            rec.append(r)
            err.append(leaf - r)
    if not with_residual:
        return tree_unflatten(treedef, payloads), None, None
    return (tree_unflatten(treedef, payloads), tree_unflatten(treedef, rec),
            tree_unflatten(treedef, err))


def decode_tree(payloads: Tree, template: Tree, mode: str) -> Tree:
    """Decode a payload tree into ``template``'s structure, shapes, dtypes."""
    fmt = get_format(mode)
    leaves, treedef = tree_flatten(template)
    return tree_unflatten(treedef, [
        fmt.decode(p, leaf.shape, leaf.dtype)
        for p, leaf in zip(flatten_up_to(treedef, payloads), leaves)])
