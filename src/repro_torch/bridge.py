"""Parameter and cache trees across the framework boundary, through numpy.

``from_numpy`` takes the JAX package's parameters (nested dicts and lists
of numpy arrays, ``jax.device_get(init_lm(...)[0])``) or one of its
decode caches (``init_cache`` of the dense or the RWKV6 stack, or the
hybrid's per-layer list) and returns the port's
tensors on a device; ``to_numpy`` is the reverse, for the parity tests,
and always copies, since the port updates its caches in place
(bf16 leaves come back as fp32, which holds them exactly).  The
layouts are the same on both sides, so nothing is transposed.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils.trees import tree_map

Tree = Any


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # JAX's bf16 (ml_dtypes): same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.as_tensor(a, device=device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:  # numpy has no bf16: fp32 holds it exactly
        t = t.to(torch.float32)
    return t.to("cpu", copy=True).numpy()


def from_numpy(tree: Tree, device) -> Tree:
    return tree_map(lambda a: _tensor(a, device), tree)


def to_numpy(tree: Tree) -> Tree:
    return tree_map(_array, tree)
