"""Fused unpack + dequant + loss-weighted merge on the card (replaces the
reference's ``kernels/dequant_merge.py:dequant_merge_packed``).

    out = any_push ? (denom*g + sum_i w2_i * (q_i*s_i)) / denom : g

over the nibble-packed int4 payload of the pod-stacked push deltas: the
unpack and the dequant happen in registers, so neither an unpacked int8
tree nor a dequantized fp32 delta tree is written to HBM.  ``denom``,
``any_push`` and ``w2`` travel in one small device buffer (no host sync).
The trimmed wire tail is re-paired into a whole canonical block by exact
plain PyTorch before the launch, as in the reference wrapper; the kernel
then skips the zero padding of ``g`` instead of padding it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import BLOCK, HALF, canonicalize_packed_ref
from repro_torch.kernels.ref import dequant_merge_packed_ref as dequant_merge_packed_plain  # noqa: F401,E501


def dequant_merge_packed_cuda(g: torch.Tensor, q_packed: torch.Tensor,
                              scales: torch.Tensor, w2: torch.Tensor,
                              denom: torch.Tensor, any_push: torch.Tensor, *,
                              axis: int = -1) -> torch.Tensor:
    """``g``: global fp32 leaf; ``q_packed``/``scales``: pod-stacked wire
    arrays with the blocks tiling ``axis`` (``axis - 1`` of ``g``, never the
    pod axis); ``w2``: (n_pods,); ``denom``/``any_push``: 0-d."""
    n_pods = q_packed.shape[0]
    for name, t, dt in (("g", g, torch.float32),
                        ("q_packed", q_packed, torch.int8),
                        ("scales", scales, torch.float32)):
        if t.device != g.device or not t.is_cuda:
            raise ValueError(f"dequant_merge_packed: {name} on {t.device}, "
                             f"g on {g.device}; all must be on one card")
        if t.dtype != dt:
            raise TypeError(f"dequant_merge_packed: {name} is {t.dtype}, "
                            f"expected {dt}")
    gs = tuple(g.shape) or (1,)
    ax = axis % q_packed.ndim
    if ax == 0:
        raise ValueError("blocked axis must not be the pod axis")
    d = gs[ax - 1]
    nb = -(-d // BLOCK)
    q_packed = canonicalize_packed_ref(q_packed, d, axis=ax).contiguous()
    want_p = (n_pods,) + gs[:ax - 1] + (nb * HALF,) + gs[ax:]
    want_s = (n_pods,) + gs[:ax - 1] + (nb,) + gs[ax:]
    if tuple(q_packed.shape) != want_p or tuple(scales.shape) != want_s:
        raise ValueError(f"dequant_merge_packed: payload {tuple(q_packed.shape)}"
                         f" / scales {tuple(scales.shape)} do not match g "
                         f"{gs} blocked on axis {ax}")
    if not (g.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequant_merge_packed: g and scales must be "
                         "contiguous")
    scal = torch.cat([t.reshape(-1).to(device=g.device, dtype=torch.float32)
                      for t in (denom, any_push, w2)])
    out = torch.empty_like(g)
    outer, inner = math.prod(gs[:ax - 1]), math.prod(gs[ax:])
    build.launch("dequant_merge_packed", g.device, g.data_ptr(),
                 q_packed.data_ptr(), scales.data_ptr(), scal.data_ptr(),
                 out.data_ptr(), n_pods, outer, d, inner, nb)
    return out
