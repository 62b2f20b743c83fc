"""Layer primitives (the reference's ``models/layers.py``): norms, the
SwiGLU and GeLU MLPs, RoPE, the encoder-decoder's sinusoidal positions,
embedding / unembedding, ``dense_init``.

Parameters are plain dicts of fp32 tensors in the reference's layout, e.g.
``mlp.wi (d, f)`` and ``embedding.head (d, V)``, never ``nn.Linear``'s
``(out, in)``: the int4 wire blocks the rightmost 256-divisible axis of
each leaf, so a transposed layout would quantize different blocks.  Each
function casts the weights it reads to the activations' dtype (the
compute dtype), as the reference does.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig

Params = Dict[str, torch.Tensor]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def dense_init(gen: torch.Generator, shape: Sequence[int], device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal * 1/sqrt(fan_in), with the reference's fan-in rule: a 3-D
    leaf takes ``shape[1]`` (so ``wq (d, H, hd)`` is scaled by 1/sqrt(H)).
    Drawn from ``gen`` on ``gen``'s device, then moved to ``device``; on
    the ``meta`` device, shapes alone (nothing is drawn)."""
    shape = tuple(shape)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    if len(shape) == 3:
        fan_in = shape[1]
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * s).to(device)


def init_norm(cfg: ModelConfig, dim: int, device) -> Params:
    p = {"scale": torch.ones((dim,), device=device)}
    if cfg.norm_kind == "layernorm":
        p["bias"] = torch.zeros((dim,), device=device)
    return p


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis: fp32 statistics, compute-dtype apply."""
    ms = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Layernorm when ``p`` has a bias, else RMS norm; fp32 statistics
    (population variance), compute-dtype apply."""
    if "bias" not in p:
        return rms_norm(x, p["scale"], eps)
    xf = x.to(torch.float32)
    var, mu = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    y = (x - mu.to(x.dtype)) * inv
    return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the erf form)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def init_mlp(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """``wi (d, f)``, ``wg (d, f)`` for SwiGLU only, ``wo (f, d)``."""
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": dense_init(gen, (d, f), device)}
    if cfg.mlp_kind == "swiglu":
        p["wg"] = dense_init(gen, (d, f), device)
    p["wo"] = dense_init(gen, (f, d), device)
    return p


def apply_mlp(p: Params, x: torch.Tensor, kind: str = "swiglu"
              ) -> torch.Tensor:
    """SwiGLU, ``(silu(x @ wg) * (x @ wi)) @ wo``, or GeLU,
    ``gelu(x @ wi) @ wo``."""
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    if kind == "swiglu":
        h = torch.nn.functional.silu(x @ p["wg"].to(dt)) * h
    elif kind == "gelu":
        h = gelu(h)
    else:
        raise ValueError(f"mlp kind {kind!r} (want swiglu|gelu)")
    return h @ p["wo"].to(dt)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (seq,).  Rotate halves."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)
    angles = positions.to(torch.float32)[:, None] * freqs   # (seq, hd/2)
    cos = torch.cos(angles)[:, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_positions(seq_len: int, dim: int) -> np.ndarray:
    """The full-sequence table ``(seq_len, dim)``, built in numpy exactly as
    the reference builds it (its encoder input and decoder forward):
    sines in the even columns, cosines in the odd."""
    pos = np.arange(seq_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * (-np.log(10000.0) / dim))
    table = np.zeros((seq_len, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table


def sinusoidal_at(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """The same embedding at positions ``(T,)`` -> ``(T, dim)``, computed
    in torch fp32 on the positions' device (the reference's decode-time
    ``sinusoidal_at``, which computes in jnp fp32 rather than reading
    the numpy table)."""
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32))
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=positions.device)
                    * (-log_base.to(positions.device) / dim))
    ang = positions.to(torch.float32)[:, None] * div
    out = torch.zeros((positions.shape[0], dim), dtype=torch.float32,
                      device=positions.device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out


def embed(p: Params, tokens: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    """Gather rows, then cast (the same values as the reference's cast of
    the whole table, without a compute-dtype copy of it)."""
    return p["table"][tokens].to(dtype)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p["head"] if "head" in p else p["table"].T
    return x @ w.to(x.dtype)
