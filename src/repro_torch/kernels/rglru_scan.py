"""The RG-LRU linear recurrence on the card (replaces the reference's
``kernels/rglru_scan.py:rglru_chunked`` and its ``kernels/ops.py:rglru``
wrapper)::

    h_t = a_t * h_{t-1} + b_t        (diagonal, one channel at a time)

Contract: ``a``, ``b`` ``(B, T, W)`` fp32, ``h0 (B, W)`` fp32 or None
(zeros); returns ``y (B, T, W)`` fp32, every step's state, and ``hT (B,
W)`` fp32, the last.  The reference's oracle is ``kernels/ref.py:
rglru_ref``.  The TPU kernel pads T with the identity ``(a=1, b=0)`` and
W to its 512-lane tile; the CUDA kernel needs neither.  Each step is a
multiply rounded to fp32, then an add rounded to fp32, never a fused
multiply-add, so the kernel equals :func:`rglru_plain` bit for bit.  See
``csrc/model_kernels.cu`` for the design.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

# constexprs of csrc/model_kernels.cu
CHANNELS = 32  # kLruChannels: channels a block (one warp, one lane each)
STEPS = 32     # kLruSteps: steps a ring slot holds
STAGES = 4     # kLruStages: ring slots (three in flight)


def rglru_plain(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None):
    """The recurrence one step at a time, as two fp32 tensor ops a step."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0.to(torch.float32)
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1), h


def rglru_cuda(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel: one lane per (batch, channel), walking T
    in order with the state in a register, a and b streamed through a
    shared-memory ring."""
    B, T, W = a.shape
    ts = (("a", a), ("b", b)) + ((("h0", h0),) if h0 is not None else ())
    for name, t in ts:
        if not t.is_cuda or t.device != a.device:
            raise ValueError(f"rglru: {name} on {t.device}; all must be on "
                             f"one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"rglru: {name} is {t.dtype}; want float32")
    if tuple(b.shape) != (B, T, W) or (h0 is not None
                                       and tuple(h0.shape) != (B, W)):
        raise ValueError(f"rglru: a {tuple(a.shape)} b {tuple(b.shape)} h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if min(B, T, W) == 0:
        raise ValueError(f"rglru: empty input B={B} T={T} W={W}")
    a, b = a.contiguous(), b.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty_like(a)
    hT = torch.empty((B, W), dtype=torch.float32, device=a.device)
    build.launch("rglru", a.device, a.data_ptr(), b.data_ptr(),
                 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                 hT.data_ptr(), B, T, W, int(vector_path(W, a, b)))
    return y, hT


def grid(B: int, W: int) -> int:
    """Blocks of ``launch_rglru``: ``CHANNELS`` of the B * W channels
    each."""
    return -(-B * W // CHANNELS)


def vector_path(W: int, *tensors: torch.Tensor) -> bool:
    """Whether the kernel copies a and b in 16-byte pieces: W a multiple
    of 4 and both 16-byte aligned; else in 4-byte pieces."""
    return W % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def launch_spec(shape) -> build.LaunchSpec:
    """The launch :func:`rglru_cuda` makes for fp32 a / b of ``shape``
    ``(B, T, W)``: one lane per (batch, channel), ``CHANNELS`` channels a
    block, a ring of ``STAGES`` slots of ``STEPS`` steps of a and b in
    static shared memory."""
    B, T, W = shape
    step, state = (1, min(T, STEPS), CHANNELS), (1, CHANNELS)
    return build.LaunchSpec(
        kernel="rglru", source=build.source("model_kernels"),
        function="rglru_kernel", grid=(grid(B, W), 1, 1),
        threads=CHANNELS, smem=0,
        static_smem=2 * STAGES * STEPS * CHANNELS * 4,
        operands=(build.Operand("a", (B, T, W), step, "float32"),
                  build.Operand("b", (B, T, W), step, "float32"),
                  build.Operand("h0", (B, W), state, "float32"),
                  build.Operand("y", (B, T, W), step, "float32"),
                  build.Operand("hT", (B, W), state, "float32")),
        accumulator="h", threads_of="kLruChannels",
        constants={"kLruChannels": CHANNELS, "kLruSteps": STEPS,
                   "kLruStages": STAGES})


def cost(shape, h0: bool = True) -> Tuple[int, int]:
    """``(operations, bytes)`` of one call at ``(B, T, W)``, fp32: a and b
    read once, every step's h and the last h written once, and ``h0``
    read when given; a multiply and an add a step and channel."""
    B, T, W = shape
    return 2 * B * T * W, 4 * (3 * B * T * W + B * W * (2 if h0 else 1))
