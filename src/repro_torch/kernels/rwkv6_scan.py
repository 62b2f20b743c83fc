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
(decode) is the same call.  :func:`plan` picks the launch; see
``csrc/model_kernels.cu`` for the design.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {"float32": 4, "bfloat16": 2}
HEAD_DIMS = (16, 32, 64, 128)
# constexprs of csrc/model_kernels.cu
KEYS = 16    # kWkvKeys: keys a block holds in prefill
COLS = 4     # kWkvCols: adjacent value columns a thread holds
STEPS = 16   # kWkvSteps: steps a ring slot holds
SLOTS = 2    # kWkvSlots: ring slots


@dataclass(frozen=True)
class Plan:
    """A WKV6 launch: ``keys`` keys of a head a block (``blocks`` blocks a
    head, launched as one cluster), ``run`` keys a thread, ``threads`` a
    block, ``smem`` dynamic shared bytes."""
    keys: int
    blocks: int
    run: int
    threads: int
    smem: int


def plan(D: int, T: int, dtype: str = "bfloat16") -> Plan:
    """The launch ``launch_wkv6`` makes for head dim ``D`` and ``T`` steps
    (the arithmetic of ``wkv_run`` / ``wkv_threads`` / ``wkv_smem_bytes``
    in the source).  Prefill splits a head's state by keys over a cluster
    of ``D / KEYS`` blocks; decode (T 1) keeps a head in one block."""
    if D not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {D}, want one of {HEAD_DIMS}")
    keys = D if T == 1 else KEYS
    run = min(16, keys // 4, keys * D // 128)
    threads = D // COLS * (keys // run)
    if T == 1:
        smem = 16 * D
    else:
        smem = (4 * D + 2 * STEPS * D * 4 + STEPS * (4 * keys + D) * 4
                + SLOTS * STEPS * D * (3 * _ITEMSIZE[dtype] + 4))
    return Plan(keys=keys, blocks=D // keys, run=run, threads=threads,
                smem=smem)


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
    """Launch the CUDA kernel as :func:`plan` says: the state in
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
    # the kernel copies and reads 16-byte vectors: a view that starts off
    # a 16-byte boundary is copied
    r, k, v, log_w, state = (_aligned(t) for t in (r, k, v, log_w, state))
    uf = u.to(torch.float32).contiguous()
    y = torch.empty_like(r)
    new_state = torch.empty_like(state)
    build.launch("wkv6", r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                 log_w.data_ptr(), uf.data_ptr(), state.data_ptr(),
                 y.data_ptr(), new_state.data_ptr(), _DTYPES[r.dtype], B, T,
                 H, D, plan(D, T).keys)
    return y, new_state


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_spec(shape, dtype: str = "bfloat16") -> build.LaunchSpec:
    """The launch :func:`wkv6_cuda` makes for r / k / v of ``shape`` ``(B,
    T, H, D)`` in ``dtype`` (:func:`plan`).  In prefill a block copies
    whole rows of r, k, v and log_w, ``STEPS`` steps at a time, owns
    ``keys`` whole rows of the state, and writes every ``blocks``-th row
    of y whole."""
    B, T, H, D = shape
    pl = plan(D, T, dtype)
    steps = min(T, STEPS)
    step = (1, steps, 1, D)
    seq = [build.Operand(name, (B, T, H, D), step, dtype)
           for name in ("r", "k", "v")]
    state = (B, H, D, D)
    rows = (1, 1, pl.keys, D)
    return build.LaunchSpec(
        kernel="wkv6", source=build.source("model_kernels"),
        function="wkv6_kernel", grid=(B * H * pl.blocks, 1, 1),
        threads=pl.threads, smem=pl.smem,
        operands=(*seq, build.Operand("log_w", (B, T, H, D), step, "float32"),
                  build.Operand("u", (H, D), (1, D), "float32"),
                  build.Operand("state", state, rows, "float32"),
                  build.Operand("y", (B, T, H, D),
                                (1, max(1, steps // pl.blocks), 1, D), dtype),
                  build.Operand("new_state", state, rows, "float32")),
        accumulator="acc", template={"T": dtype},
        threads_of=f"{D} / kWkvCols * ({pl.keys} / {pl.run})",
        constants={"kWkvKeys": KEYS, "kWkvCols": COLS, "kWkvSteps": STEPS,
                   "kWkvSlots": SLOTS})


def cost(shape, dtype=torch.bfloat16, u_dtype=torch.float32
         ) -> Tuple[int, int]:
    """``(operations, bytes)`` of one call at r / k / v ``(B, T, H, D)`` in
    ``dtype`` with fp32 ``log_w`` and state and ``u`` in ``u_dtype``: r, k,
    v, log_w, u and the state read once, y and the new state written once;
    7 operations a state element a step (k v, u k v, add, r dot, decay,
    accumulate, and the read-out's sum)."""
    B, T, H, D = shape
    n = B * T * H * D
    state = B * H * D * D
    return 7 * D * D * B * H * T, \
        n * (4 * dtype.itemsize + 4) + H * D * u_dtype.itemsize + 8 * state
