"""RWKV6 ("Finch") time-mix and channel-mix blocks with data-dependent
decay (the reference's ``models/rwkv.py``).

WKV6 recurrence per head (state S: key_dim x value_dim)::

    y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

with per-channel, per-token decay ``w_t = exp(-exp(w0 + lora(x)))``.

``impl`` of :func:`apply_time_mix`: ``scan`` is the exact step-by-step
recurrence in plain PyTorch, the reference's decode path and its oracle;
``kernel`` reaches ``kernels.ops.wkv6``, the CUDA kernel for a CUDA
tensor, which computes the same exact recurrence.  The reference's
``chunked`` form (its ``auto`` beyond 64 steps) clamps each cumulative
log-decay at +-30 separately and is wrong under strong decay, so it is
not ported, and neither is ``auto``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.rwkv6_scan import wkv6_plain as wkv_scan
from repro_torch.models.layers import dense_init

__all__ = ["init_time_mix", "apply_time_mix", "init_channel_mix",
           "apply_channel_mix", "init_rwkv_state", "wkv_scan"]

MIX_LORA = 32
DECAY_LORA = 64


def init_time_mix(cfg: ModelConfig, gen: torch.Generator,
                  device) -> Dict[str, torch.Tensor]:
    d, H, D = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    if H * D != d:
        raise ValueError(f"{cfg.name}: {H} heads of {D} != d_model {d}")

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    return {
        "mu_x": zeros(d),
        "mu": zeros(5, d),
        "mix_w1": dense_init(gen, (d, 5 * MIX_LORA), device),
        "mix_w2": dense_init(gen, (5, MIX_LORA, d), device),
        "decay_base": zeros(d),
        "decay_w1": dense_init(gen, (d, DECAY_LORA), device),
        "decay_w2": dense_init(gen, (DECAY_LORA, d), device),
        "bonus_u": zeros(H, D),
        "wr": dense_init(gen, (d, d), device),
        "wk": dense_init(gen, (d, d), device),
        "wv": dense_init(gen, (d, d), device),
        "wg": dense_init(gen, (d, d), device),
        "wo": dense_init(gen, (d, d), device),
        "ln_scale": torch.ones((d,), device=device),
        "ln_bias": zeros(d),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Shift right by one along time; ``prev`` supplies the t=-1 row."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(p, x: torch.Tensor, xprev: torch.Tensor):
    """Data-dependent interpolation: the 5 mixed inputs (w, k, v, r, g)."""
    dt = x.dtype
    xx = xprev - x
    base = x + xx * p["mu_x"].to(dt)
    z = torch.tanh(base @ p["mix_w1"].to(dt))
    B, T, _ = x.shape
    z = z.reshape(B, T, 5, MIX_LORA)
    off = torch.einsum("btnl,nld->nbtd", z, p["mix_w2"].to(dt))
    return [x + xx * (p["mu"][i].to(dt) + off[i]) for i in range(5)]


def _time_mix_proj(p, x, xprev, cfg: ModelConfig):
    """Project to the (r, k, v, g, log_decay) head tensors."""
    dt = x.dtype
    H, D = cfg.num_heads, cfg.resolved_head_dim
    B, T, _ = x.shape
    x_w, x_k, x_v, x_r, x_g = _ddlerp(p, x, xprev)
    r = (x_r @ p["wr"].to(dt)).reshape(B, T, H, D)
    k = (x_k @ p["wk"].to(dt)).reshape(B, T, H, D)
    v = (x_v @ p["wv"].to(dt)).reshape(B, T, H, D)
    g = torch.nn.functional.silu(x_g @ p["wg"].to(dt))
    f32 = torch.float32
    dec = p["decay_base"].to(f32) + (x_w.to(f32) @ p["decay_w1"].to(f32)) \
        @ p["decay_w2"].to(f32)
    log_w = -torch.exp(dec).reshape(B, T, H, D)  # log w_t < 0: w in (0, 1)
    return r, k, v, g, log_w


def _group_norm(y: torch.Tensor, scale, bias, eps: float = 64e-5
                ) -> torch.Tensor:
    """Per-head layernorm (H groups) of y (B, T, H, D): fp32 statistics,
    compute-dtype apply."""
    var, mu = torch.var_mean(y.to(torch.float32), dim=-1, keepdim=True,
                             correction=0)
    inv = torch.rsqrt(var + eps).to(y.dtype)
    yn = (y - mu.to(y.dtype)) * inv
    B, T, H, D = y.shape
    return yn.reshape(B, T, H * D) * scale.to(y.dtype) + bias.to(y.dtype)


def apply_time_mix(p, x: torch.Tensor, cfg: ModelConfig, *,
                   state: Optional[Dict[str, torch.Tensor]] = None,
                   impl: str = "scan"):
    """Full-sequence time-mix; ``state`` carries (wkv, last token) across
    calls.  Returns ``(out, new_state)`` (``None`` without a state)."""
    B, T, d = x.shape
    H, D = cfg.num_heads, cfg.resolved_head_dim
    prev = state["tm_x"][:, None] if state is not None else None
    wkv0 = (state["wkv"] if state is not None
            else torch.zeros((B, H, D, D), device=x.device))
    xprev = _token_shift(x, prev)
    r, k, v, g, log_w = _time_mix_proj(p, x, xprev, cfg)
    if impl == "kernel":
        y, wkv = kops.wkv6(r, k, v, log_w, p["bonus_u"], wkv0)
    elif impl == "scan":
        y, wkv = wkv_scan(r, k, v, log_w, p["bonus_u"], wkv0)
    else:
        raise ValueError(f"time-mix impl {impl!r} (want scan|kernel)")
    y = _group_norm(y, p["ln_scale"], p["ln_bias"])
    y = y * g.reshape(B, T, d)
    out = y @ p["wo"].to(x.dtype)
    new_state = None
    if state is not None:
        new_state = {"wkv": wkv, "tm_x": x[:, -1]}
    return out, new_state


def init_channel_mix(cfg: ModelConfig, gen: torch.Generator,
                     device) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.zeros((d,), device=device),
        "mu_r": torch.zeros((d,), device=device),
        "wk": dense_init(gen, (d, f), device),
        "wv": dense_init(gen, (f, d), device),
        "wr": dense_init(gen, (d, d), device),
    }


def apply_channel_mix(p, x: torch.Tensor, *,
                      state: Optional[Dict[str, torch.Tensor]] = None):
    """Squared-relu channel mix with a sigmoid receptance gate.  Returns
    ``(out, new_state)`` (``None`` without a state)."""
    dt = x.dtype
    prev = state["cm_x"][:, None] if state is not None else None
    xx = _token_shift(x, prev) - x
    xk = x + xx * p["mu_k"].to(dt)
    xr = x + xx * p["mu_r"].to(dt)
    h = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    kv = h @ p["wv"].to(dt)
    out = torch.sigmoid(xr @ p["wr"].to(dt)) * kv
    new_state = {"cm_x": x[:, -1]} if state is not None else None
    return out, new_state


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """One layer's decode state: the fp32 WKV state and the last token of
    each mix, on the card unless ``device`` names the CPU."""
    device = resolve_device(device)
    H, D = cfg.num_heads, cfg.resolved_head_dim
    return {
        "wkv": torch.zeros((batch, H, D, D), device=device),
        "tm_x": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "cm_x": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
    }
