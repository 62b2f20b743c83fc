"""The RWKV6 WKV recurrence on the card (replaces the reference's
``kernels/rwkv6_scan.py:wkv6_chunked`` and its ``kernels/ops.py:wkv6``
wrapper).

Per head, with the ``(D, D)`` key x value state ``S``::

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(exp(log_w_t)) S_{t-1} + k_t^T v_t

Contract, in the model layout: r / k / v ``(B, T, H, D)`` in the compute
dtype, ``log_w (B, T, H, D)`` fp32, ``u (H, D)``, ``state (B, H, D, D)``
fp32; returns y in r's dtype and the new fp32 state.  This is the
*exact* recurrence (the reference's ``kernels/ref.py:wkv6_ref`` and
``models/rwkv.py:wkv_scan``).  The TPU kernel's chunked form clamps the
cumulative log-decay of each factor to +-30 separately, which breaks the
cancellation ``e^{L_{t-1}} e^{-L_s}`` once the decay is strong (log_w
below about -0.5 over a 64-step chunk); that clamp is not copied.  T = 1
(decode) is the same call.  See ``csrc/model_kernels.cu`` for the design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
SPLIT = 4    # kWkvSplit of csrc/model_kernels.cu: threads per value column
STEPS = 16   # kWkvSteps: steps a block stages in shared memory at a time


def wkv6_plain(r, k, v, log_w, u, state):
    """The exact recurrence, one step at a time, in fp32."""
    rf, kf, vf = (a.to(torch.float32) for a in (r, k, v))
    wf = torch.exp(log_w.to(torch.float32))
    uf = u.to(torch.float32)[None, :, :, None]
    S = state.to(torch.float32)
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]   # (B, H, D, D)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S


def wkv6_cuda(r, k, v, log_w, u, state):
    """Launch the CUDA kernel: one block per (batch, head), the state in
    registers, every step in order."""
    B, T, H, D = r.shape
    for name, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w),
                    ("u", u), ("state", state)):
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"wkv6: {name} on {t.device}; all must be on "
                             f"one CUDA device")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6: r/k/v {r.dtype}/{k.dtype}/{v.dtype}; want "
                        f"one of float32, bfloat16")
    if log_w.dtype != torch.float32 or state.dtype != torch.float32:
        raise TypeError(f"wkv6: log_w {log_w.dtype}, state {state.dtype}; "
                        f"both must be float32")
    if (tuple(k.shape) != (B, T, H, D) or tuple(v.shape) != (B, T, H, D)
            or tuple(log_w.shape) != (B, T, H, D)
            or tuple(u.shape) != (H, D)
            or tuple(state.shape) != (B, H, D, D)):
        raise ValueError(f"wkv6: r {tuple(r.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} log_w {tuple(log_w.shape)} u "
                         f"{tuple(u.shape)} state {tuple(state.shape)}")
    if D not in HEAD_DIMS or min(B, T, H) == 0:
        raise ValueError(f"wkv6: head dim {D} (want one of {HEAD_DIMS}), "
                         f"B={B} T={T} H={H}")
    r, k, v, log_w, state = (t.contiguous() for t in (r, k, v, log_w, state))
    uf = u.to(torch.float32).contiguous()
    y = torch.empty_like(r)
    new_state = torch.empty_like(state)
    build.launch("wkv6", r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                 log_w.data_ptr(), uf.data_ptr(), state.data_ptr(),
                 y.data_ptr(), new_state.data_ptr(), _DTYPES[r.dtype], B, T,
                 H, D)
    return y, new_state


def launch_spec(shape, dtype: str = "bfloat16") -> build.LaunchSpec:
    """The launch :func:`wkv6_cuda` makes for r / k / v of ``shape`` ``(B,
    T, H, D)`` in ``dtype``: one block of ``SPLIT * D`` threads per
    (batch, head), staging ``STEPS`` steps at a time."""
    B, T, H, D = shape
    step = (1, STEPS, 1, D)
    seq = [build.Operand(name, (B, T, H, D), step, dtype)
           for name in ("r", "k", "v")]
    state = (B, H, D, D)
    return build.LaunchSpec(
        kernel="wkv6", source=build.source("model_kernels"),
        function="wkv6_kernel", grid=(B * H, 1, 1), threads=SPLIT * D,
        smem=0, static_smem=4 * 4 * STEPS * D,  # rs, ks, vs, ws: fp32
        operands=(*seq, build.Operand("log_w", (B, T, H, D), step, "float32"),
                  build.Operand("u", (H, D), (1, D), "float32"),
                  build.Operand("state", state, (1, 1, D, D), "float32"),
                  build.Operand("y", (B, T, H, D), step, dtype),
                  build.Operand("new_state", state, (1, 1, D, D),
                                "float32")),
        accumulator="acc", template={"T": dtype},
        threads_of=f"kWkvSplit * {D}",
        constants={"kWkvSplit": SPLIT, "kWkvSteps": STEPS})
