"""Fused loss-weighted merge on the card (replaces the reference's
``kernels/loss_weighted_update.py:loss_weighted_update``).

    out = any_push ? (w1*g + sum_i w2_i*pods_i) / denom : g

one flat elementwise pass with the pods accumulated in order in fp32, for
the ``none``/``fp16`` wires.  ``g`` and ``pods`` share one dtype, fp32,
bf16 or fp16, widened on load and rounded once on store.  The scalars
travel in one device buffer.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dequant_merge import DTYPES
from repro_torch.kernels.ref import loss_weighted_update_ref as loss_weighted_update_plain  # noqa: F401,E501


def loss_weighted_update_cuda(g: torch.Tensor, pods: torch.Tensor,
                              w1: torch.Tensor, w2: torch.Tensor,
                              denom: torch.Tensor, any_push: torch.Tensor
                              ) -> torch.Tensor:
    """``g``: an fp32, bf16 or fp16 leaf; ``pods``: (n_pods,) + g.shape
    of g's dtype."""
    for name, t in (("g", g), ("pods", pods)):
        if not t.is_cuda or t.device != g.device:
            raise ValueError(f"loss_weighted_update: {name} on {t.device}, "
                             f"g on {g.device}; all must be on one card")
        if t.dtype not in DTYPES or t.dtype != g.dtype:
            raise TypeError(f"loss_weighted_update: {name} is {t.dtype}, "
                            f"expected g's dtype, one of {tuple(DTYPES)}")
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
                 pods.shape[0], g.numel(), DTYPES[g.dtype])
    return out


def launch_spec(g_shape, n_pods: int, dtype: str = "float32"
                ) -> build.LaunchSpec:
    """The launch :func:`loss_weighted_update_cuda` makes for a leaf of
    ``dtype``: one thread per element of the flat leaf, every pod read in
    the same step."""
    n = math.prod(g_shape)
    t = build.WIRE_THREADS
    return build.LaunchSpec(
        kernel="loss_weighted_update", source=build.source("wire_kernels"),
        function="loss_weighted_update_kernel",
        grid=(build.grid_for(n), 1, 1), threads=t, smem=0,
        operands=(build.Operand("g", (n,), (t,), dtype),
                  build.Operand("pods", (n_pods, n), (n_pods, t), dtype),
                  build.Operand("scal", (3 + n_pods,), (3 + n_pods,),
                                "float32"),
                  build.Operand("out", (n,), (t,), dtype)),
        accumulator="acc", template={"T": dtype}, threads_of="kThreads",
        constants={"kThreads": t})
