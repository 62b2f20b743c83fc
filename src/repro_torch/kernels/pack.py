"""Nibble pack / unpack on the card (replaces the reference's
``kernels/pack.py:pack_int4`` / ``unpack_int4`` Pallas kernels).

Layout: within each 256-element quantization block of the blocked
``axis``, packed byte ``k`` holds element ``k`` in its low nibble and
element ``k + 128`` in its high nibble (two's complement, [-8, 7]).  The
CUDA kernels take the leaf as a 3-D view ``(outer, d, inner)`` with the
blocked axis in the middle, so unlike the reference wrapper
(``pack.py:52-69``) no ``moveaxis`` copy is made.  Bound by HBM bytes;
see ``csrc/wire_kernels.cu``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import BLOCK, HALF
from repro_torch.kernels.ref import pack_nibbles_ref as pack_int4_plain  # noqa: F401
from repro_torch.kernels.ref import unpack_nibbles_ref as unpack_int4_plain  # noqa: F401


def _view3(shape, axis: int, width: int):
    """(outer, d, inner) of ``shape`` around ``axis``; ``d % width == 0``."""
    ax = axis % len(shape)
    d = shape[ax]
    if d % width:
        raise ValueError(f"axis {ax} of {tuple(shape)} is not a whole number "
                         f"of {width}-wide blocks")
    return math.prod(shape[:ax]), d, math.prod(shape[ax + 1:]), ax


def _check(x: torch.Tensor, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int8:
        raise TypeError(f"{name}: expected int8, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty tensor")


def pack_int4_cuda(q: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """int8 nibbles in [-8, 7] -> packed int8 with ``axis`` halved."""
    _check(q, "pack_int4")
    outer, d, inner, ax = _view3(q.shape, axis, BLOCK)
    shape = list(q.shape)
    shape[ax] = d // 2
    p = torch.empty(shape, dtype=torch.int8, device=q.device)
    build.launch("pack_int4", q.device, q.data_ptr(), p.data_ptr(), outer,
                 d // 2, inner)
    return p


def unpack_int4_cuda(p: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4_cuda` (exact, sign included)."""
    _check(p, "unpack_int4")
    outer, dh, inner, ax = _view3(p.shape, axis, HALF)
    shape = list(p.shape)
    shape[ax] = dh * 2
    q = torch.empty(shape, dtype=torch.int8, device=p.device)
    build.launch("unpack_int4", p.device, p.data_ptr(), q.data_ptr(), outer,
                 dh, inner)
    return q
