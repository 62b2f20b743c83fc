"""Fused dequant + loss-weighted merge on the card (replaces the
reference's ``kernels/dequant_merge.py:dequant_merge`` (int8) and
``dequant_merge_packed`` (int4)).

    out = any_push ? (denom*g + sum_i w2_i * (q_i*s_i)) / denom : g

over the blocked wire payload of the pod-stacked push deltas: the dequant
(and for int4 the unpack) happens in registers, so no dequantized fp32
delta tree is written to HBM.  ``denom``, ``any_push`` and ``w2`` travel in
one small device buffer (no host sync).  Both kernels view the leaf as
``(outer, d, inner)`` around the blocked axis and write only the real
``d`` elements, so ``g`` is never padded.  The int8 kernel reads the
trimmed wire ``q`` where it lies; for int4 the trimmed wire tail is
re-paired into a whole canonical block by exact plain PyTorch before the
launch, as in the reference wrapper.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import BLOCK, HALF, canonicalize_packed_ref
from repro_torch.kernels.ref import dequant_merge_packed_ref as dequant_merge_packed_plain  # noqa: F401,E501
from repro_torch.kernels.ref import dequant_merge_ref as dequant_merge_plain  # noqa: F401,E501


def _check(name: str, g: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
           axis: int):
    """Device, dtype and axis checks shared by both merges; returns
    ``(g.shape or (1,), ax, d, nb)``."""
    for arg, t, dt in (("g", g, torch.float32), ("q", q, torch.int8),
                       ("scales", scales, torch.float32)):
        if t.device != g.device or not t.is_cuda:
            raise ValueError(f"{name}: {arg} on {t.device}, g on {g.device}; "
                             f"all must be on one card")
        if t.dtype != dt:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dt}")
    if not (g.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{name}: g and scales must be contiguous")
    gs = tuple(g.shape) or (1,)
    ax = axis % q.ndim
    if ax == 0:
        raise ValueError("blocked axis must not be the pod axis")
    d = gs[ax - 1]
    return gs, ax, d, -(-d // BLOCK)


def _launch(name, g, q, scales, w2, denom, any_push, n_pods, gs, ax, d, nb):
    scal = torch.cat([t.reshape(-1).to(device=g.device, dtype=torch.float32)
                      for t in (denom, any_push, w2)])
    out = torch.empty_like(g)
    outer, inner = math.prod(gs[:ax - 1]), math.prod(gs[ax:])
    build.launch(name, g.device, g.data_ptr(), q.data_ptr(), scales.data_ptr(),
                 scal.data_ptr(), out.data_ptr(), n_pods, outer, d, inner, nb)
    return out


def dequant_merge_cuda(g: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                       w2: torch.Tensor, denom: torch.Tensor,
                       any_push: torch.Tensor, *, axis: int = -1
                       ) -> torch.Tensor:
    """``g``: global fp32 leaf; ``q``: the pod-stacked trimmed int8 wire
    array, ``(n_pods,) + g.shape``; ``scales``: one fp32 per 256-block of
    ``axis`` (``axis - 1`` of ``g``, never the pod axis); ``w2``:
    (n_pods,); ``denom``/``any_push``: 0-d."""
    gs, ax, d, nb = _check("dequant_merge", g, q, scales, axis)
    n_pods = q.shape[0]
    want_s = (n_pods,) + gs[:ax - 1] + (nb,) + gs[ax:]
    if tuple(q.shape) != (n_pods,) + gs or tuple(scales.shape) != want_s:
        raise ValueError(f"dequant_merge: payload {tuple(q.shape)} / scales "
                         f"{tuple(scales.shape)} do not match g {gs} blocked "
                         f"on axis {ax}")
    if not q.is_contiguous():
        raise ValueError("dequant_merge: q must be contiguous")
    return _launch("dequant_merge", g, q, scales, w2, denom, any_push, n_pods,
                   gs, ax, d, nb)


def dequant_merge_packed_cuda(g: torch.Tensor, q_packed: torch.Tensor,
                              scales: torch.Tensor, w2: torch.Tensor,
                              denom: torch.Tensor, any_push: torch.Tensor, *,
                              axis: int = -1) -> torch.Tensor:
    """``g``: global fp32 leaf; ``q_packed``/``scales``: pod-stacked wire
    arrays with the blocks tiling ``axis`` (``axis - 1`` of ``g``, never the
    pod axis); ``w2``: (n_pods,); ``denom``/``any_push``: 0-d."""
    gs, ax, d, nb = _check("dequant_merge_packed", g, q_packed, scales, axis)
    n_pods = q_packed.shape[0]
    q_packed = canonicalize_packed_ref(q_packed, d, axis=ax).contiguous()
    want_p = (n_pods,) + gs[:ax - 1] + (nb * HALF,) + gs[ax:]
    want_s = (n_pods,) + gs[:ax - 1] + (nb,) + gs[ax:]
    if tuple(q_packed.shape) != want_p or tuple(scales.shape) != want_s:
        raise ValueError(f"dequant_merge_packed: payload {tuple(q_packed.shape)}"
                         f" / scales {tuple(scales.shape)} do not match g "
                         f"{gs} blocked on axis {ax}")
    return _launch("dequant_merge_packed", g, q_packed, scales, w2, denom,
                   any_push, n_pods, gs, ax, d, nb)


def launch_spec(kernel: str, g_shape, n_pods: int, axis: int = -1
                ) -> build.LaunchSpec:
    """The launch ``kernel`` (``"dequant_merge"`` or
    ``"dequant_merge_packed"``) makes for a global leaf of ``g_shape`` and
    ``n_pods`` pods, blocked on ``axis`` of the pod-stacked payload: one
    thread per output element, every pod read in the same step.  A step's
    ``WIRE_THREADS`` outputs read as many int8 bytes per pod, or half as
    many packed bytes, and one scale per pod and block (a gather)."""
    gs = tuple(g_shape) or (1,)
    ax = axis % (len(gs) + 1)
    d = gs[ax - 1]
    nb = -(-d // BLOCK)
    outer, inner = math.prod(gs[:ax - 1]), math.prod(gs[ax:])
    n = outer * d * inner
    t = build.WIRE_THREADS
    if kernel == "dequant_merge_packed":
        q = build.Operand("q_packed", (n_pods, outer * nb * HALF * inner),
                          (n_pods, t // 2), "int8")
    else:
        q = build.Operand("q", (n_pods, n), (n_pods, t), "int8")
    scales = build.Operand("scales", (n_pods, outer * nb * inner),
                           (n_pods, 1), "float32", gather=True)
    return build.LaunchSpec(
        kernel=kernel, source=build.source("wire_kernels"),
        function=f"{kernel}_kernel", grid=(build.grid_for(n), 1, 1),
        threads=t, smem=0,
        operands=(build.Operand("g", (n,), (t,), "float32"), q, scales,
                  build.Operand("scal", (2 + n_pods,), (2 + n_pods,),
                                "float32"),
                  build.Operand("out", (n,), (t,), "float32")),
        accumulator="acc", threads_of="kThreads",
        constants={"kBlock": BLOCK, "kHalf": HALF, "kThreads": t})
