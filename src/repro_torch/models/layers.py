"""Layer primitives of the dense LM (the reference's ``models/layers.py``,
fp32): RMSNorm, SwiGLU MLP, RoPE, embedding / unembedding, ``dense_init``.

Parameters are plain dicts of tensors in the reference's layout, e.g.
``mlp.wi (d, f)`` and ``embedding.head (d, V)``, never ``nn.Linear``'s
``(out, in)``: the int4 wire blocks the rightmost 256-divisible axis of
each leaf, so a transposed layout would quantize different blocks.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def dense_init(gen: torch.Generator, shape: Sequence[int], device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal * 1/sqrt(fan_in), with the reference's fan-in rule: a 3-D
    leaf takes ``shape[1]`` (so ``wq (d, H, hd)`` is scaled by 1/sqrt(H)).
    Drawn from ``gen`` on ``gen``'s device, then moved to ``device``."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    if len(shape) == 3:
        fan_in = shape[1]
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * s).to(device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis: ``x * rsqrt(mean(x^2) + eps) * scale``."""
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * scale


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x @ wg) * (x @ wi)) @ wo``."""
    h = x @ p["wi"]
    g = x @ p["wg"]
    return (torch.nn.functional.silu(g) * h) @ p["wo"]


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (seq,).  Rotate halves."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)
    angles = positions.to(torch.float32)[:, None] * freqs   # (seq, hd/2)
    cos = torch.cos(angles)[:, None, :]
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p["head"] if "head" in p else p["table"].T
    return x @ w
