"""Fused fp32 loss-weighted merge on the card (replaces the reference's
``kernels/loss_weighted_update.py:loss_weighted_update``).

    out = any_push ? (w1*g + sum_i w2_i*pods_i) / denom : g

one flat elementwise pass with the pods accumulated in order, for the
``none``/``fp16`` wires.  The scalars travel in one device buffer.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import loss_weighted_update_ref as loss_weighted_update_plain  # noqa: F401,E501


def loss_weighted_update_cuda(g: torch.Tensor, pods: torch.Tensor,
                              w1: torch.Tensor, w2: torch.Tensor,
                              denom: torch.Tensor, any_push: torch.Tensor
                              ) -> torch.Tensor:
    """``g``: fp32 leaf; ``pods``: (n_pods,) + g.shape fp32."""
    for name, t in (("g", g), ("pods", pods)):
        if not t.is_cuda or t.device != g.device:
            raise ValueError(f"loss_weighted_update: {name} on {t.device}, "
                             f"g on {g.device}; all must be on one card")
        if t.dtype != torch.float32:
            raise TypeError(f"loss_weighted_update: {name} is {t.dtype}, "
                            f"expected float32")
        if not t.is_contiguous():
            raise ValueError(f"loss_weighted_update: {name} not contiguous")
    if tuple(pods.shape[1:]) != tuple(g.shape) or g.numel() == 0:
        raise ValueError(f"loss_weighted_update: pods {tuple(pods.shape)} "
                         f"vs g {tuple(g.shape)}")
    scal = torch.cat([t.reshape(-1).to(device=g.device, dtype=torch.float32)
                      for t in (w1, denom, any_push, w2)])
    out = torch.empty_like(g)
    build.launch("loss_weighted_update", g.device, g.data_ptr(),
                 pods.data_ptr(), scal.data_ptr(), out.data_ptr(),
                 pods.shape[0], g.numel())
    return out
