"""The RG-LRU recurrent block of RecurrentGemma / Griffin (the reference's
``models/rglru.py``).

Recurrence, per channel, with ``a_t`` data-dependent in (0, 1)::

    r_t = sigmoid(W_a x_t + b_a)                 (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                 (input gate)
    log a_t = -c * softplus(Lambda) * r_t        (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block wraps the LRU with a causal depthwise conv1d input branch and a
GeLU gate branch.  The port mirrors the reference, not the published
Griffin: the reference's RecurrentGemma has no embedding normaliser, no
logit soft-cap and a plain pre-norm residual layout, and so does this.

``impl`` of :func:`apply_rglru_block`: ``seq`` is the exact step
recurrence in plain PyTorch (``models.lm`` maps its ``rec_impl="scan"``,
the name the WKV step loop shares, onto it); ``kernel`` reaches
``kernels.ops.rglru``, the CUDA kernel for a CUDA tensor, which computes
the same steps bit for bit.  The reference's associative scan and its
chunked closed form (which clamps at +-30) are not serving paths here;
the CPU tests hold the port against them where the reference takes them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.rglru_scan import rglru_plain
from repro_torch.models.layers import dense_init, gelu

LRU_C = 8.0


def _width(cfg: ModelConfig) -> int:
    return cfg.recurrent.lru_width or cfg.d_model


def init_rglru_block(cfg: ModelConfig, gen: torch.Generator,
                     device) -> Dict[str, torch.Tensor]:
    """The reference's leaves and scales; ``lam`` is deterministic, so
    that ``a`` spans (0.9, 0.999) at init."""
    d, w, cw = cfg.d_model, _width(cfg), cfg.recurrent.conv1d_width
    a0 = np.linspace(0.9, 0.999, w, dtype=np.float32)
    lam = np.log(np.expm1(-np.log(a0) / LRU_C)).astype(np.float32)
    zeros = lambda: torch.zeros((w,), device=device)  # noqa: E731
    return {
        "w_in_x": dense_init(gen, (d, w), device),
        "w_in_g": dense_init(gen, (d, w), device),
        "conv_w": dense_init(gen, (cw, w), device, scale=0.5),
        "conv_b": zeros(),
        "gate_a_w": dense_init(gen, (w, w), device),
        "gate_a_b": zeros(),
        "gate_x_w": dense_init(gen, (w, w), device),
        "gate_x_b": zeros(),
        "lam": torch.from_numpy(lam).to(device),
        "w_out": dense_init(gen, (w, d), device),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv: x (B, T, w), w (CW, w), ``prev`` the last
    CW - 1 inputs before x (B, CW - 1, w) or None (zeros)."""
    cw = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def lru_gates(p, x: torch.Tensor):
    """x (B, T, w) -> (a, gated input), both fp32."""
    xf = x.to(torch.float32)
    f32 = torch.float32
    r = torch.sigmoid(xf @ p["gate_a_w"].to(f32) + p["gate_a_b"].to(f32))
    i = torch.sigmoid(xf @ p["gate_x_w"].to(f32) + p["gate_x_b"].to(f32))
    log_a = -LRU_C * torch.nn.functional.softplus(p["lam"].to(f32)) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) \
        * (i * xf)
    return a, gated


def apply_rglru_block(p, x: torch.Tensor, cfg: ModelConfig, *,
                      state: Optional[Dict[str, torch.Tensor]] = None,
                      impl: str = "seq"):
    """The recurrent block: x (B, T, d) -> (out (B, T, d), new state or
    None).  With a ``state`` (``h`` fp32, ``conv`` the last CW - 1 conv
    inputs) it continues from it and returns the next one, as new
    tensors; the caller writes them into its cache."""
    dt = x.dtype
    xin = torch.einsum("btd,dw->btw", x, p["w_in_x"].to(dt))
    gate = gelu(torch.einsum("btd,dw->btw", x, p["w_in_g"].to(dt)))
    prev_conv = state["conv"] if state is not None else None
    xc = causal_conv1d(xin, p["conv_w"], p["conv_b"], prev_conv)
    a, bt = lru_gates(p, xc)
    h0 = state["h"] if state is not None else None
    if impl == "kernel":
        h, hT = kops.rglru(a, bt, h0)
    elif impl == "seq":
        h, hT = rglru_plain(a, bt, h0)
    else:
        raise ValueError(f"rglru impl {impl!r} (want seq|kernel)")
    out = torch.einsum("btw,wd->btd", h.to(dt) * gate, p["w_out"].to(dt))
    if state is None:
        return out, None
    cw = p["conv_w"].shape[0]
    tail = torch.cat([prev_conv.to(dt), xin], dim=1)[:, -(cw - 1):] \
        if cw > 1 else prev_conv
    return out, {"h": hT, "conv": tail}


def init_rglru_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """One RG-LRU layer's decode state: the fp32 ``h`` and the conv tail,
    on the card unless ``device`` names the CPU."""
    device = resolve_device(device)
    w, cw = _width(cfg), cfg.recurrent.conv1d_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cw - 1, w), dtype=dtype,
                                device=device)}
