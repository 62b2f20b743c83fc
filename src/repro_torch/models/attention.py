"""GQA attention (the reference's ``models/attention.py``, dense train
path): ``naive`` materialises the (Sq, Skv) scores, ``blocked`` is the
flash-style online softmax over KV chunks in plain PyTorch.  ``auto``
picks naive up to 256 x 256 scores, as the reference does.

Layouts are the reference's: q (B, S, H, D), k/v (B, S, K, D), H = K*G,
and the projections ``wq (d, H, hd)``, ``wk/wv (d, K, hd)``,
``wo (H, hd, d)``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rms_norm

NEG_INF = -1e30


def _mask(qpos, kpos, causal: bool) -> torch.Tensor:
    m = kpos[None, :] >= 0
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    return m


def naive_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    B, Sq, H, D = q.shape
    K, Skv = k.shape[2], k.shape[1]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    qq = q.reshape(B, Sq, K, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qq, k) * scale
    pos = torch.arange(max(Sq, Skv), device=q.device)
    mask = _mask(pos[:Sq], pos[:Skv], causal)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def blocked_attention(q, k, v, *, causal: bool = True, q_chunk: int = 1024,
                      kv_chunk: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention carrying (acc, row_max, row_sum) over KV
    chunks for each query chunk; equal to :func:`naive_attention`."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    pq, pk = (-Sq) % q_chunk, (-Skv) % kv_chunk
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
        qpos = torch.cat([qpos, qpos[-1:].expand(pq)])
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
        kpos = torch.cat([kpos, kpos.new_full((pk,), -1)])
    nq, nk = q.shape[1] // q_chunk, k.shape[1] // kv_chunk
    qc = q.reshape(B, nq, q_chunk, K, G, D)
    kc = k.reshape(B, nk, kv_chunk, K, D)
    vc = v.reshape(B, nk, kv_chunk, K, Dv)
    outs = []
    for qi in range(nq):
        qb = qc[:, qi]
        qp = qpos[qi * q_chunk:(qi + 1) * q_chunk]
        acc = q.new_zeros((B, K, G, q_chunk, Dv))
        mx = q.new_full((B, K, G, q_chunk), NEG_INF)
        sm = q.new_zeros((B, K, G, q_chunk))
        for ki in range(nk):
            kp = kpos[ki * kv_chunk:(ki + 1) * kv_chunk]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kc[:, ki]) * scale
            s = torch.where(_mask(qp, kp, causal), s,
                            torch.full_like(s, NEG_INF))
            new_mx = torch.maximum(mx, torch.amax(s, dim=-1))
            alpha = torch.exp(mx - new_mx)
            p = torch.exp(s - new_mx[..., None])
            sm = sm * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] \
                + torch.einsum("bkgqs,bskd->bkgqd", p, vc[:, ki])
            mx = new_mx
        outs.append(acc / torch.clamp(sm, min=1e-30)[..., None])
    out = torch.stack(outs)  # (nq, B, K, G, qc, Dv)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, nq * q_chunk, H, Dv)
    return out[:, :Sq]


def attention_impl(q, k, v, *, causal: bool = True,
                   impl: str = "auto") -> torch.Tensor:
    if impl == "auto":
        impl = "naive" if q.shape[1] * k.shape[1] <= 256 * 256 else "blocked"
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal)
    if impl == "blocked":
        return blocked_attention(q, k, v, causal=causal)
    raise ValueError(f"attention impl {impl!r} (want auto|naive|blocked)")


def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   device) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(gen, (d, H, hd), device),
        "wk": dense_init(gen, (d, K, hd), device),
        "wv": dense_init(gen, (d, K, hd), device),
        "wo": dense_init(gen, (H, hd, d), device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=device)
        p["k_norm"] = torch.ones((hd,), device=device)
    return p


def _project_qkv(p, x, cfg: ModelConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply_attention(p, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, causal: bool = True,
                    impl: str = "auto") -> torch.Tensor:
    """Full-sequence self-attention.  x: (B, S, d)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = attention_impl(q, k, v, causal=causal, impl=impl)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])
