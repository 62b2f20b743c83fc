"""GQA attention, Multi-head Latent Attention (MLA) and their caches (the
reference's ``models/attention.py``).

``naive`` materialises the (Sq, Skv) scores, ``blocked`` is the
flash-style online softmax over KV chunks in plain PyTorch, and ``auto``
picks naive up to 256 x 256 scores, as the reference does; all three run
in fp32 and return q's dtype.  ``kernel`` is the port's counterpart of the
reference's ``pallas``: it reaches ``kernels.ops.flash_attention`` (the
CUDA kernel for a CUDA tensor), which takes the positions the reference's
Pallas wrapper drops.  The kernel has no backward, so training keeps
``auto``.

Masks: key ``s`` is visible to query ``i`` when its position is ``>= 0``
(a written cache slot), and, when causal, not after the query, and, with
a window, less than ``window`` before it.

Layouts are the reference's: q (B, S, H, D), k/v (B, S, K, D), H = K*G,
and the projections ``wq (d, H, hd)``, ``wk/wv (d, K, hd)``,
``wo (H, hd, d)``.  Decode caches are updated in place (the reference
returns new arrays): ``decode_attention`` writes the new keys and values
into the cache it is given and returns that same dict.

Cross-attention (the encoder-decoder's decoder): ``apply_attention(...,
kv=(k, v))`` projects only q from x and attends, not causally, over the
given keys and values (the encoder's, ``kv_positions`` ``0..Skv-1``), in
the forward and in decode alike.

MLA (DeepSeek-V2): full-rank queries ``wq (d, H, nope + rope)``; keys and
values from a ``kv_lora_rank`` latent (``w_dkv``, RMS-normed by
``kv_norm``, expanded by ``w_uk (r, H, nope)`` and ``w_uv (r, H, vd)``)
and one RoPE key ``w_kr (d, rope)`` shared by the heads.  Attention runs
at ``D = nope + rope`` against ``Dv = vd`` with the scale ``D^-0.5``,
through ``attention_impl``, so ``impl="kernel"`` reaches the flash
kernels at ``(D, Dv)`` (192 / 128 at deepseek-v2-lite).  Its cache holds
the latent and the RoPE key per position (``init_mla_cache``), expanded
to per-head keys and values at every step, as the reference does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import NEG_INF, visible
from repro_torch.models.layers import apply_rope, dense_init, rms_norm


def _positions(positions, n: int, device) -> torch.Tensor:
    if positions is None:
        return torch.arange(n, device=device)
    return positions


def naive_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    qq = q.reshape(B, Sq, K, G, D).to(torch.float32)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qq,
                          k.to(torch.float32)) * scale
    mask = visible(_positions(q_positions, Sq, q.device),
                   _positions(kv_positions, k.shape[1], q.device),
                   causal=causal, window=window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def blocked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_positions: Optional[torch.Tensor] = None,
                      kv_positions: Optional[torch.Tensor] = None,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
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
    qpos = _positions(q_positions, Sq, q.device)
    kpos = _positions(kv_positions, Skv, q.device)
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
        qpos = torch.cat([qpos, qpos[-1:].expand(pq)])
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
        kpos = torch.cat([kpos, kpos.new_full((pk,), -1)])
    nq, nk = q.shape[1] // q_chunk, k.shape[1] // kv_chunk
    qc = q.reshape(B, nq, q_chunk, K, G, D).to(torch.float32)
    kc = k.reshape(B, nk, kv_chunk, K, D).to(torch.float32)
    vc = v.reshape(B, nk, kv_chunk, K, Dv).to(torch.float32)
    outs = []
    for qi in range(nq):
        qb = qc[:, qi]
        qp = qpos[qi * q_chunk:(qi + 1) * q_chunk]
        acc = qc.new_zeros((B, K, G, q_chunk, Dv))
        mx = qc.new_full((B, K, G, q_chunk), NEG_INF)
        sm = qc.new_zeros((B, K, G, q_chunk))
        for ki in range(nk):
            kp = kpos[ki * kv_chunk:(ki + 1) * kv_chunk]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kc[:, ki]) * scale
            s = torch.where(visible(qp, kp, causal=causal, window=window),
                            s, torch.full_like(s, NEG_INF))
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
    return out[:, :Sq].to(q.dtype)


def attention_impl(q, k, v, *, causal: bool = True, window: int = 0,
                   q_positions: Optional[torch.Tensor] = None,
                   kv_positions: Optional[torch.Tensor] = None,
                   impl: str = "auto",
                   scale: Optional[float] = None) -> torch.Tensor:
    if impl == "auto":
        impl = "naive" if q.shape[1] * k.shape[1] <= 256 * 256 else "blocked"
    kw = dict(causal=causal, window=window, scale=scale)
    if impl == "kernel":
        return kops.flash_attention(
            q, k, v, _positions(q_positions, q.shape[1], q.device),
            _positions(kv_positions, k.shape[1], q.device), **kw)
    if impl == "naive":
        return naive_attention(q, k, v, q_positions=q_positions,
                               kv_positions=kv_positions, **kw)
    if impl == "blocked":
        return blocked_attention(q, k, v, q_positions=q_positions,
                                 kv_positions=kv_positions, **kw)
    raise ValueError(f"attention impl {impl!r} "
                     f"(want auto|naive|blocked|kernel)")


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


def _project(p, name, x, cfg: ModelConfig, positions):
    """One of q (``wq``) or k (``wk``) with its qk-norm and RoPE, or v."""
    t = torch.einsum("bsd,dhk->bshk", x, p[name].to(x.dtype))
    if name == "wv":
        return t
    if cfg.qk_norm:
        t = rms_norm(t, p["q_norm" if name == "wq" else "k_norm"])
    if cfg.use_rope:
        t = apply_rope(t, positions, cfg.rope_theta)
    return t


def _project_qkv(p, x, cfg: ModelConfig, positions):
    return tuple(_project(p, name, x, cfg, positions)
                 for name in ("wq", "wk", "wv"))


def apply_attention(p, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, causal: bool = True,
                    window: int = 0, impl: str = "auto",
                    kv=None) -> torch.Tensor:
    """Full-sequence attention.  x: (B, S, d).  With ``kv`` (the encoder's
    keys and values, ``(B, Senc, K, hd)`` each) it is cross-attention:
    only q comes from x, and no key is masked."""
    if kv is None:
        q, k, v = _project_qkv(p, x, cfg, positions)
    else:
        q, (k, v), causal = _project(p, "wq", x, cfg, positions), kv, False
    out = attention_impl(q, k, v, causal=causal, window=window,
                         q_positions=positions, impl=impl)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  window: int = 0, dtype=torch.bfloat16,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Linear cache, or ring buffer of ``window`` slots for local
    attention; ``pos`` is each slot's absolute position, -1 if unwritten.
    On the card unless ``device`` names the CPU."""
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    slots = min(max_len, window) if window > 0 else max_len
    shape = (batch, slots, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((slots,), -1, dtype=torch.int32, device=device),
    }


def decode_attention(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                     cfg: ModelConfig, *, pos: int, window: int = 0,
                     impl: str = "auto"):
    """Stateful attention: x (B, T, d) starting at absolute position
    ``pos``.  T == 1 is token decode; T > 1 is prefill.  A linear cache
    attends over all its slots (unwritten ones masked by ``pos = -1``);
    a ring buffer (``window > 0``) prefills over the raw sequence and
    keeps the last ``slots`` positions.  Returns ``(out, cache)``, the
    cache written in place."""
    T = x.shape[1]
    positions = torch.arange(pos, pos + T, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slots = ck.shape[1]
    if window > 0 and T > 1:
        out = attention_impl(q, k, v, causal=True, window=window,
                             q_positions=positions, impl=impl)
        tail = min(slots, T)
        tail_pos = positions[-tail:]
        idx = tail_pos % slots
        ck[:, idx] = k[:, -tail:].to(ck.dtype)
        cv[:, idx] = v[:, -tail:].to(cv.dtype)
        cpos[idx] = tail_pos.to(torch.int32)
    else:
        slot = pos % slots if window > 0 else pos
        if slot + T > slots:
            raise ValueError(f"decode_attention: {T} positions from slot "
                             f"{slot} overrun a {slots}-slot cache")
        ck[:, slot:slot + T] = k.to(ck.dtype)
        cv[:, slot:slot + T] = v.to(cv.dtype)
        cpos[slot:slot + T] = positions.to(torch.int32)
        out = attention_impl(q, ck, cv, causal=True, window=window,
                             q_positions=positions, kv_positions=cpos,
                             impl=impl)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, cache


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, gen: torch.Generator,
             device) -> Dict[str, torch.Tensor]:
    """The reference's tree, drawn in its order: ``wq``, ``w_dkv``,
    ``w_kr``, ``w_uk``, ``w_uv``, ``wo``; ``kv_norm`` ones."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    nope = cfg.resolved_head_dim
    vd = m.v_head_dim or nope
    r = m.kv_lora_rank
    p = {"wq": dense_init(gen, (d, H, nope + m.rope_head_dim), device),
         "w_dkv": dense_init(gen, (d, r), device),
         "w_kr": dense_init(gen, (d, m.rope_head_dim), device),
         "kv_norm": torch.ones((r,), device=device)}
    p["w_uk"] = dense_init(gen, (r, H, nope), device)
    p["w_uv"] = dense_init(gen, (r, H, vd), device)
    p["wo"] = dense_init(gen, (H, vd, d), device)
    return p


def _mla_qkv(p, x, cfg: ModelConfig, positions):
    """``(q_nope, q_rope, c_kv, k_rope)`` of x ``(B, S, d)``: the queries'
    two parts (RoPE on the second), the normed latent and the RoPE key."""
    dt = x.dtype
    nope = cfg.resolved_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = rms_norm(x @ p["w_dkv"].to(dt), p["kv_norm"])
    k_rope = x @ p["w_kr"].to(dt)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand(p, c_kv, k_rope, dt):
    """The latent ``(B, S, r)`` and RoPE key ``(B, S, rope)`` expanded to
    per-head keys ``(B, S, H, nope + rope)`` and values ``(B, S, H,
    vd)``."""
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"].to(dt))
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uv"].to(dt))
    kr = k_rope[:, :, None, :].expand(k_rope.shape[:2] + (k_nope.shape[2],
                                                          k_rope.shape[-1]))
    return torch.cat([k_nope, kr], dim=-1), v


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.resolved_head_dim + cfg.mla.rope_head_dim) ** -0.5


def apply_mla(p, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Full-sequence causal MLA.  x: (B, S, d)."""
    dt = x.dtype
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    k, v = _mla_expand(p, c_kv, k_rope, dt)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = attention_impl(q, k, v, causal=True, q_positions=positions,
                         impl=impl, scale=_mla_scale(cfg))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   dtype=torch.bfloat16,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """The latent ``c_kv (B, max_len, r)``, the RoPE key ``k_rope (B,
    max_len, rope)`` and each slot's position (-1 unwritten), on the card
    unless ``device`` names the CPU."""
    device = resolve_device(device)
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, m.rope_head_dim),
                              dtype=dtype, device=device),
        "pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
    }


def decode_mla(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: ModelConfig, *, pos: int, impl: str = "auto"):
    """Stateful MLA: x (B, T, d) from absolute position ``pos`` (T > 1 is
    prefill).  Writes the latent and RoPE key of the T positions into
    the cache in place, then attends over every slot of it.  Returns
    ``(out, cache)``."""
    dt = x.dtype
    T = x.shape[1]
    positions = torch.arange(pos, pos + T, dtype=torch.int32,
                             device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    ckv, ckr, cpos = cache["c_kv"], cache["k_rope"], cache["pos"]
    if pos + T > ckv.shape[1]:
        raise ValueError(f"decode_mla: {T} positions from {pos} overrun a "
                         f"{ckv.shape[1]}-slot cache")
    ckv[:, pos:pos + T] = c_kv.to(ckv.dtype)
    ckr[:, pos:pos + T] = k_rope.to(ckr.dtype)
    cpos[pos:pos + T] = positions
    k, v = _mla_expand(p, ckv.to(dt), ckr.to(dt), dt)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = attention_impl(q, k, v, causal=True, q_positions=positions,
                         kv_positions=cpos, impl=impl,
                         scale=_mla_scale(cfg))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt)), cache
