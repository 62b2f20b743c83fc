"""Kernel dispatch: a CUDA tensor goes to the CUDA kernel, a CPU tensor to
its plain PyTorch version.  There is no other route: a CUDA tensor reaches
the kernel or an exception, never the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels import dequant_merge as _dqm
from repro_torch.kernels import loss_weighted_update as _lwu
from repro_torch.kernels import pack as _pk


def pack_int4(q: torch.Tensor, *, axis: int = -1) -> torch.Tensor:
    """Two int4 nibbles per int8 byte along the blocked ``axis``."""
    if q.is_cuda:
        return _pk.pack_int4_cuda(q, axis=axis)
    return _pk.pack_int4_plain(q, axis=axis)


def unpack_int4(p: torch.Tensor, *, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4` (exact, sign included)."""
    if p.is_cuda:
        return _pk.unpack_int4_cuda(p, axis=axis)
    return _pk.unpack_int4_plain(p, axis=axis)


def dequant_merge_packed(g, q_packed, scales, w2, denom, any_push, *,
                         axis: int = -1) -> torch.Tensor:
    """Merge nibble-packed int4 payloads straight into the global leaf."""
    if g.is_cuda:
        return _dqm.dequant_merge_packed_cuda(g, q_packed, scales, w2, denom,
                                              any_push, axis=axis)
    return _dqm.dequant_merge_packed_plain(g, q_packed, scales, w2, denom,
                                           any_push, axis=axis)


def loss_weighted_update(g, pods, w1, w2, denom, any_push) -> torch.Tensor:
    """``any_push ? (w1*g + sum_i w2_i*pods_i) / denom : g``."""
    if g.is_cuda:
        return _lwu.loss_weighted_update_cuda(g, pods, w1, w2, denom,
                                              any_push)
    return _lwu.loss_weighted_update_plain(g, pods, w1, w2, denom, any_push)
