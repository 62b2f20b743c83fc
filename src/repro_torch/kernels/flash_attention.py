"""GQA flash attention with position masks on the card (replaces the
reference's ``kernels/flash_attention.py:flash_attention`` and its
``kernels/ops.py:flash_attention`` wrapper).

Contract, in the model layout: q ``(B, Sq, H, D)``, k / v ``(B, Skv, K,
Dv)`` with ``H = K * G``, query head ``h`` reading KV head ``h // G``;
``q_positions (Sq,)`` and ``kv_positions (Skv,)`` int32.  Key ``s`` is
visible to query ``i`` when ``kv_positions[s] >= 0`` (a written cache
slot), and, if ``causal``, ``kv_positions[s] <= q_positions[i]``, and, if
``window > 0``, ``q_positions[i] - kv_positions[s] < window``: the masks
of the reference's ``naive_attention``.  The TPU kernel's wrapper drops
the positions and takes query ``i`` to sit at position ``i``, which is
wrong in decode; the kernel here takes them.  fp32 inside, the scale
applied to q before ``q k^T``, masked scores at ``-1e30`` and the row sum
floored at ``1e-30``, as in the TPU kernel.  Output ``(B, Sq, H, Dv)`` in
q's dtype.  See ``csrc/model_kernels.cu`` for the design.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
THREADS = 256   # kFaThreads of csrc/model_kernels.cu
KV_TILE = 64    # kBK: keys a block stages per step


def visible(q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
            causal: bool, window: int) -> torch.Tensor:
    """The ``(Sq, Skv)`` boolean mask of the contract."""
    qp, kp = q_positions[:, None], kv_positions[None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & ((qp - kp) < window)
    return m


def flash_attention_plain(q, k, v, q_positions, kv_positions, *,
                          causal: bool = True, window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, in fp32, one softmax over
    all of ``Skv``."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    qf = q.to(torch.float32).reshape(B, Sq, K, H // K, D) * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(torch.float32))
    m = visible(q_positions, kv_positions, causal=causal, window=window)
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    mx = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - mx)
    l = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", p / l, v.to(torch.float32))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def flash_attention_cuda(q, k, v, q_positions, kv_positions, *,
                         causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel (fp32 or bf16 q/k/v of one dtype, ``D ==
    Dv`` in :data:`HEAD_DIMS`)."""
    B, Sq, H, D = q.shape
    Skv, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v), ("q_positions",
                                                   q_positions),
                    ("kv_positions", kv_positions)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}; all "
                             f"must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; want one of float32, bfloat16")
    if (k.shape[0] != B or tuple(v.shape[:3]) != tuple(k.shape[:3])
            or k.shape[3] != D or H % K):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if D != Dv or D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims {D}/{Dv}; the kernel "
                         f"takes D == Dv in {HEAD_DIMS}")
    if tuple(q_positions.shape) != (Sq,) or \
            tuple(kv_positions.shape) != (Skv,):
        raise ValueError(f"flash_attention: positions "
                         f"{tuple(q_positions.shape)} / "
                         f"{tuple(kv_positions.shape)} for Sq={Sq}, "
                         f"Skv={Skv}")
    if min(B, Sq, Skv) == 0:
        raise ValueError("flash_attention: empty input")
    scale = scale if scale is not None else D ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    qp = q_positions.to(torch.int32).contiguous()
    kp = kv_positions.to(torch.int32).contiguous()
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    build.launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), qp.data_ptr(), kp.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], B, Sq, Skv, H, K, D, int(causal),
                 int(window), float(scale))
    return out


def launch_spec(q_shape, k_shape, dtype: str = "float32"
                ) -> build.LaunchSpec:
    """The launch :func:`flash_attention_cuda` makes for q ``(B, Sq, H,
    D)`` and k / v ``(B, Skv, K, D)`` of ``dtype``: one block per (q tile,
    head, batch), ``dim3((Sq + BQ - 1) / BQ, H, B)`` with BQ 16 rows for
    Sq <= 16 (decode) and 64 otherwise, walking the keys ``KV_TILE`` at a
    time; the shared memory of ``fa_smem_bytes<BQ, D>``."""
    B, Sq, H, D = q_shape
    Skv, K = k_shape[1], k_shape[2]
    bq = 16 if Sq <= 16 else 64
    smem = 4 * (bq * (D + 1) + 2 * KV_TILE * (D + 1) + bq * (KV_TILE + 1))
    q_tile, kv_tile = (1, bq, 1, D), (1, KV_TILE, 1, D)
    return build.LaunchSpec(
        kernel="flash_attention", source=build.source("model_kernels"),
        function="flash_attention_kernel", grid=(-(-Sq // bq), H, B),
        threads=THREADS, smem=smem,
        operands=(build.Operand("q", tuple(q_shape), q_tile, dtype),
                  build.Operand("k", (B, Skv, K, D), kv_tile, dtype),
                  build.Operand("v", (B, Skv, K, D), kv_tile, dtype),
                  build.Operand("q_positions", (Sq,), (bq,), "int32"),
                  build.Operand("kv_positions", (Skv,), (KV_TILE,),
                                "int32"),
                  build.Operand("out", tuple(q_shape), q_tile, dtype)),
        accumulator="acc", template={"T": dtype}, threads_of="kFaThreads",
        constants={"kFaThreads": THREADS, "kBK": KV_TILE})
