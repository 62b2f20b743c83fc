"""Flat blockwise int8 quantize / dequantize on the card (replaces the
reference's ``kernels/quantize.py:quantize_int8`` / ``dequantize_int8``).

The whole array is flattened and cut into 256-element absmax blocks:
``q`` is ``(ceil(n/256), 256)`` int8 and ``scales`` ``(ceil(n/256), 1)``
fp32, the layout of the reference's ``quantize_int8_ref``.  The TPU
kernel's row padding to a multiple of 64 is not copied, and the
dequantize writes every element up to ``n`` whatever the row count.  Both
kernels are bound by HBM bytes; see ``csrc/wire_kernels.cu``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import BLOCK
from repro_torch.kernels.ref import dequantize_int8_ref as dequantize_int8_plain  # noqa: F401,E501
from repro_torch.kernels.ref import quantize_int8_ref as quantize_int8_plain  # noqa: F401,E501


def quantize_int8_cuda(x: torch.Tensor):
    """``x`` (any shape, cast to fp32 as the plain version casts) ->
    ``(q, scales)``."""
    if not x.is_cuda:
        raise ValueError(f"quantize_int8: expected a CUDA tensor, got "
                         f"{x.device}")
    n = x.numel()
    if n == 0:
        raise ValueError("quantize_int8: empty tensor")
    flat = x.reshape(-1).to(torch.float32).contiguous()
    nb = -(-n // BLOCK)
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=x.device)
    scales = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    build.launch("quantize_int8", x.device, flat.data_ptr(), q.data_ptr(),
                 scales.data_ptr(), n, nb)
    return q, scales


def dequantize_int8_cuda(q: torch.Tensor, scales: torch.Tensor, shape
                         ) -> torch.Tensor:
    """``(rows, 256)`` int8 and ``(rows, 1)`` fp32 -> fp32 of ``shape``;
    ``rows * 256`` must cover ``prod(shape)``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    for name, t, dt in (("q", q, torch.int8), ("scales", scales,
                                                torch.float32)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"dequantize_int8: {name} on {t.device}; both "
                             f"must be on one card")
        if t.dtype != dt:
            raise TypeError(f"dequantize_int8: {name} is {t.dtype}, "
                            f"expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"dequantize_int8: {name} not contiguous")
    rows = q.shape[0]
    if (q.ndim != 2 or q.shape[1] != BLOCK
            or tuple(scales.shape) != (rows, 1)):
        raise ValueError(f"dequantize_int8: q {tuple(q.shape)} / scales "
                         f"{tuple(scales.shape)}, want (rows, {BLOCK}) / "
                         f"(rows, 1)")
    if not 0 < n <= rows * BLOCK:
        raise ValueError(f"dequantize_int8: {n} elements from {rows} rows")
    out = torch.empty(shape, dtype=torch.float32, device=q.device)
    build.launch("dequantize_int8", q.device, q.data_ptr(), scales.data_ptr(),
                 out.data_ptr(), n)
    return out


def launch_spec(kernel: str, shape) -> build.LaunchSpec:
    """The launch ``kernel`` (``"quantize_int8"`` or ``"dequantize_int8"``)
    makes for an fp32 array of ``shape``.  The quantize takes one warp per
    256-block, so a block's step is ``WIRE_THREADS // 32`` rows of the
    ``(nb, 256)`` layout; the dequantize four elements per thread.  Each
    block's scale is a gather."""
    n = math.prod(shape)
    nb = -(-n // BLOCK)
    t = build.WIRE_THREADS
    if kernel == "quantize_int8":
        rows = t // 32
        grid = build.grid_for(nb * 32)
        ops = (build.Operand("x", (nb, BLOCK), (rows, BLOCK), "float32"),
               build.Operand("q", (nb, BLOCK), (rows, BLOCK), "int8"),
               build.Operand("scales", (nb,), (rows,), "float32",
                             gather=True))
    else:
        step = 4 * t
        grid = build.grid_for(-(-n // 4))
        ops = (build.Operand("q", (n,), (step,), "int8"),
               build.Operand("scales", (nb,), (step // BLOCK,), "float32",
                             gather=True),
               build.Operand("out", (n,), (step,), "float32"))
    return build.LaunchSpec(
        kernel=kernel, source=build.source("wire_kernels"),
        function=f"{kernel}_kernel", grid=(grid, 1, 1), threads=t, smem=0,
        operands=ops, threads_of="kThreads",
        constants={"kBlock": BLOCK, "kThreads": t})


def cost(kernel: str, shape, dtype: torch.dtype = torch.float32
         ) -> Tuple[int, int]:
    """``(operations, bytes)`` of one call on an array of ``shape`` (the
    quantized array's, in ``dtype``; the dequantize writes fp32): the
    array, ``q`` and ``scales`` each moved once.  The quantize's
    operations are 6 an output element (abs, max, divide, round, clamp,
    convert), the dequantize's one multiply an output element."""
    n = math.prod(shape)
    nb = -(-n // BLOCK)
    wire = nb * BLOCK + 4 * nb
    if kernel == "quantize_int8":
        return 6 * (nb * BLOCK + nb), n * dtype.itemsize + wire
    return n, wire + 4 * n
