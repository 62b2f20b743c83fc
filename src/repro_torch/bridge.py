"""Parameter trees across the framework boundary, through numpy.

``from_numpy`` takes the JAX package's parameters as a nested dict of
numpy arrays (``jax.device_get(init_lm(...)[0])``) and returns the port's
tensors on a device; ``to_numpy`` is the reverse, for the parity tests.
The layouts are the same on both sides, so nothing is transposed.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils.trees import tree_map

Tree = Any


def from_numpy(tree: Tree, device) -> Tree:
    return tree_map(lambda a: torch.as_tensor(np.array(a), device=device),
                    tree)


def to_numpy(tree: Tree) -> Tree:
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
