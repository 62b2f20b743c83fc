"""Tree-level push-payload encoding with error feedback and its billing
(the reference's ``dist/compression.py``: ``encode_tree``,
``decode_tree``, ``compress_tree``, ``payload_bytes``).

    eff           = tree + error          (error defaults to zeros)
    payloads      = encode(eff)           per leaf
    reconstructed = decode(payloads)      what the receiver sees
    new_error     = eff - reconstructed

The caller keeps ``new_error`` and folds it into the next push, so the
compression bias telescopes over rounds (Karimireddy et al., 2019).
Stochastic formats (int4) draw leaf ``i``'s noise under the key
``(round_step, i)``, ``i`` in the reference's leaf order.  Each format
encodes (and, for the residual, decodes) the whole tree at once, so the
int4 pack and unpack are one launch each on a card.

The flat ``quantize_int8`` / ``dequantize_int8`` pair keeps the
whole-array layout of the reference's ``kernels/quantize.py`` for callers
that want it: a CUDA tensor runs the CUDA kernels, a CPU tensor their
plain versions.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.dist.wire import NoiseFn, get_format
from repro_torch.kernels import ops
from repro_torch.utils.trees import (
    flatten_up_to, tree_flatten, tree_map, tree_unflatten,
)

Tree = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (any shape) -> ``(q (nblocks, 256) int8, scales (nblocks, 1)
    fp32)``: blockwise absmax over the flattened array, ``scale =
    max|x_block|/127``, ``q = round(x/scale)``, half to even."""
    return ops.quantize_int8(x)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, shape
                    ) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`; the trailing block padding is
    discarded."""
    return ops.dequantize_int8(q, scales, tuple(shape))


def encode_tree(tree: Tree, mode: str, error: Optional[Tree] = None, *,
                round_step: int = 0, noise: Optional[NoiseFn] = None,
                with_residual: bool = True
                ) -> Tuple[Tree, Optional[Tree], Optional[Tree]]:
    """Returns ``(payloads, reconstructed, new_error)``; the last two are
    None with ``with_residual=False`` (nothing is decoded then)."""
    fmt = get_format(mode)
    eff = tree if error is None else tree_map(lambda a, b: a + b, tree, error)
    leaves, treedef = tree_flatten(eff)
    payloads = fmt.encode_group(
        leaves, [(round_step, i) for i in range(len(leaves))], noise)
    if not with_residual:
        return tree_unflatten(treedef, payloads), None, None
    rec = fmt.decode_group(payloads, [x.shape for x in leaves],
                           [x.dtype for x in leaves])
    err = [x - r for x, r in zip(leaves, rec)]
    return (tree_unflatten(treedef, payloads), tree_unflatten(treedef, rec),
            tree_unflatten(treedef, err))


def decode_tree(payloads: Tree, template: Tree, mode: str) -> Tree:
    """Decode a payload tree into ``template``'s structure, shapes, dtypes."""
    fmt = get_format(mode)
    leaves, treedef = tree_flatten(template)
    return tree_unflatten(treedef, fmt.decode_group(
        flatten_up_to(treedef, payloads), [x.shape for x in leaves],
        [x.dtype for x in leaves]))


def compress_tree(tree: Tree, mode: str, error: Optional[Tree] = None, *,
                  round_step: int = 0, noise: Optional[NoiseFn] = None
                  ) -> Tuple[Tree, Tree]:
    """Compress-decompress a payload tree with error feedback: returns
    ``(reconstructed, new_error)``, what crosses the wire after a round
    trip and the residual the sender folds into its next payload."""
    _, rec, err = encode_tree(tree, mode, error, round_step=round_step,
                              noise=noise)
    return rec, err


def payload_bytes(tree: Tree, mode: str, *, param_axes=None,
                  rules=None) -> int:
    """Wire bytes for one push of ``tree`` under ``mode``, *measured* per
    leaf from the format's encoded payload (block padding, scales and the
    int4 nibble packing included; ``WireFormat.payload_bytes``, on
    ``meta`` tensors).  Leaf dtypes are ignored: the wire format is
    billed as for fp32 leaves, not the in-memory dtype (``none`` ships a
    leaf's own dtype, so a bf16 tree's ``none`` wire is half its bill).

    ``param_axes`` (a tree of ``tree``'s structure, one logical-axes
    tuple a leaf: ``models.lm.param_axes``) and ``rules`` forward
    ``block_axis``' sharding hint leaf by leaf; the memo is keyed on the
    resolved blocked axis."""
    fmt = get_format(mode)  # an unknown mode raises even for an empty tree
    leaves, treedef = tree_flatten(tree)
    if param_axes is None:
        return sum(fmt.payload_bytes(x.shape) for x in leaves)
    axes = flatten_up_to(treedef, param_axes)
    return sum(fmt.payload_bytes(x.shape, axes=a, rules=rules)
               for x, a in zip(leaves, axes))
