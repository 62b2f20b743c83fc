"""Mixture-of-Experts: a top-k router with sort-based capacity dispatch (the
reference's ``models/moe.py``).

Two implementations of one function, tested against each other:

* ``dense``:  every expert runs on every token, weighted by a one-hot
  combine; exact, ``E`` times the FLOPs of the routed tokens; the oracle,
  and the path of short inputs (decode);
* ``sorted``: tokens sorted by expert (a stable argsort), bucketed into
  ``(E, C, d)`` at a capacity ``C`` of ``top_k * tokens / E *
  capacity_factor`` rounded up to a multiple of 8, the experts run as one
  batched product, the outputs scattered back and summed in fp32
  (``index_add_``).  Rows past an expert's capacity are dropped (sent to
  a dummy slot), as in the reference.

Expert weights are stacked ``wi / wg (E, d, ff)``, ``wo (E, ff, d)``; the
router is ``(d, E)`` and runs in fp32.  The products are plain
``torch.einsum`` / ``matmul``: the reference computes them outside any
Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import dense_init, gelu

Params = Dict[str, torch.Tensor]


def init_moe(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """The reference's tree: ``router``, ``wi``, ``wo``, ``wg`` (SwiGLU),
    and the shared experts' joint ``shared_wi``, ``shared_wo``,
    ``shared_wg`` (``(d, n_shared * shared_ff)``), drawn in that order."""
    me, d = cfg.moe, cfg.d_model
    E, ff = me.num_experts, me.expert_ff
    gated = cfg.mlp_kind == "swiglu"
    p = {"router": dense_init(gen, (d, E), device),
         "wi": dense_init(gen, (E, d, ff), device),
         "wo": dense_init(gen, (E, ff, d), device)}
    if gated:
        p["wg"] = dense_init(gen, (E, d, ff), device)
    if me.num_shared_experts:
        sf = (me.shared_ff or me.expert_ff) * me.num_shared_experts
        p["shared_wi"] = dense_init(gen, (d, sf), device)
        p["shared_wo"] = dense_init(gen, (sf, d), device)
        if gated:
            p["shared_wg"] = dense_init(gen, (d, sf), device)
    return p


def _act(cfg: ModelConfig, h: torch.Tensor,
         g: Optional[torch.Tensor] = None) -> torch.Tensor:
    if cfg.mlp_kind == "swiglu":
        return torch.nn.functional.silu(g) * h
    if cfg.mlp_kind == "relu_sq":
        return torch.square(torch.relu(h))
    return gelu(h)


def _router(p: Params, x2d: torch.Tensor, me
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d ``(T, d)`` -> the top-k weights ``(T, k)`` (fp32, renormalised
    to sum 1 with a 1e-9 floor) and expert ids ``(T, k)``."""
    logits = x2d.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    wk, ids = torch.topk(probs, me.top_k, dim=-1)
    wk = wk / torch.clamp(torch.sum(wk, dim=-1, keepdim=True), min=1e-9)
    return wk, ids


def _shared(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["shared_wi"].to(dt)
    g = x @ p["shared_wg"].to(dt) if "shared_wg" in p else None
    return _act(cfg, h, g) @ p["shared_wo"].to(dt)


def moe_dense(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Oracle: every expert runs on every token.  x ``(B, S, d)``."""
    me = cfg.moe
    dt = x.dtype
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    wk, ids = _router(p, x2d, me)
    comb = torch.zeros((B * S, me.num_experts), dtype=torch.float32,
                       device=x.device).scatter_add_(1, ids, wk)
    # the reference's "td,edf->tef" as a batched product over the experts,
    # which reads each expert's weights in place
    h = torch.matmul(x2d, p["wi"].to(dt))
    g = torch.matmul(x2d, p["wg"].to(dt)) if "wg" in p else None
    y = torch.matmul(_act(cfg, h, g), p["wo"].to(dt))        # (E, T, d)
    out = torch.einsum("etd,te->td", y.to(torch.float32), comb).to(dt)
    out = out.reshape(B, S, d)
    if me.num_shared_experts:
        out = out + _shared(p, x, cfg)
    return out


def _dispatch_group(x2d: torch.Tensor, wk: torch.Tensor, ids: torch.Tensor,
                    cfg: ModelConfig, capacity: int):
    """Sort-based dispatch of ONE token group, x2d ``(Tg, d)``: the
    experts' buckets ``(E, capacity, d)`` and the route ``(slot,
    sorted_tok, sorted_w, keep)`` that :func:`_combine_group` reads."""
    me = cfg.moe
    Tg, d = x2d.shape
    k, E = me.top_k, me.num_experts
    dev = x2d.device
    flat_ids = ids.reshape(-1)
    flat_w = wk.reshape(-1)
    token_of = torch.arange(Tg, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_ids, stable=True)     # group by expert
    sorted_e = flat_ids[order]
    sorted_tok = token_of[order]
    sorted_w = flat_w[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev, dtype=sorted_e.dtype),
        side="left")
    pos_in_e = torch.arange(Tg * k, device=dev) - seg_start[sorted_e]
    keep = pos_in_e < capacity                       # capacity drop
    slot = torch.where(keep, sorted_e * capacity + pos_in_e,
                       torch.full_like(pos_in_e, E * capacity))
    bucket = torch.zeros((E * capacity + 1, d), dtype=x2d.dtype, device=dev)
    bucket[slot] = x2d[sorted_tok]
    eb = bucket[:-1].reshape(E, capacity, d)
    return eb, (slot, sorted_tok, sorted_w, keep)


def _combine_group(y: torch.Tensor, route, Tg: int, dt) -> torch.Tensor:
    """Scatter one group's expert outputs ``y (E, C, d)`` back to its
    ``Tg`` tokens, weighted, summed in fp32, cast to ``dt``."""
    slot, sorted_tok, sorted_w, keep = route
    E, capacity, d = y.shape
    yflat = y.reshape(E * capacity, d)
    contrib = yflat[torch.clamp(slot, max=E * capacity - 1)]
    contrib = torch.where(keep[:, None], contrib * sorted_w[:, None].to(dt),
                          torch.zeros_like(contrib))
    out = torch.zeros((Tg, d), dtype=torch.float32, device=y.device)
    out.index_add_(0, sorted_tok, contrib.to(torch.float32))
    return out.to(dt)


def capacity_of(cfg: ModelConfig, Tg: int) -> int:
    """Slots an expert takes per group of ``Tg`` tokens, as the reference
    computes it: ``int(k Tg / E * cf + 0.999)``, clamped to ``[1, Tg]``,
    rounded up to a multiple of 8."""
    me = cfg.moe
    capacity = int((me.top_k * Tg / me.num_experts) * me.capacity_factor
                   + 0.999)
    capacity = max(min(capacity, Tg), 1)
    return ((capacity + 7) // 8) * 8


def moe_sorted(p: Params, x: torch.Tensor, cfg: ModelConfig,
               capacity: Optional[int] = None, groups: int = 1
               ) -> torch.Tensor:
    """The production path: per-group sort dispatch, then the
    capacity-bucketed FFN.  ``groups`` splits the tokens into blocks
    dispatched on their own, each with ``capacity`` slots an expert
    (halved to a divisor of the token count, as in the reference; one
    card runs one group)."""
    me = cfg.moe
    dt = x.dtype
    B, S, d = x.shape
    T = B * S
    G = max(1, min(groups, T))
    while T % G:
        G //= 2  # fall back to a divisor
    Tg = T // G
    if capacity is None:
        capacity = capacity_of(cfg, Tg)
    xg = x.reshape(G, Tg, d)
    wk, ids = _router(p, x.reshape(T, d), me)
    wk = wk.reshape(G, Tg, me.top_k)
    ids = ids.reshape(G, Tg, me.top_k)
    routes, buckets = [], []
    for gi in range(G):
        eb, route = _dispatch_group(xg[gi], wk[gi], ids[gi], cfg, capacity)
        buckets.append(eb)
        routes.append(route)
    eb = torch.stack(buckets)
    h = torch.einsum("gecd,edf->gecf", eb, p["wi"].to(dt))
    g = torch.einsum("gecd,edf->gecf", eb, p["wg"].to(dt)) if "wg" in p \
        else None
    y = torch.einsum("gecf,efd->gecd", _act(cfg, h, g), p["wo"].to(dt))
    out = torch.stack([_combine_group(y[gi], routes[gi], Tg, dt)
                       for gi in range(G)])
    out = out.reshape(B, S, d)
    if me.num_shared_experts:
        out = out + _shared(p, x, cfg)
    return out


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
              impl: str = "auto", groups: int = 1) -> torch.Tensor:
    """``impl``: ``dense``, ``sorted``, or ``auto`` (dense at 512 tokens
    or fewer, else sorted)."""
    if impl == "auto":
        impl = "dense" if x.shape[0] * x.shape[1] <= 512 else "sorted"
    if impl == "dense":
        return moe_dense(p, x, cfg)
    if impl == "sorted":
        return moe_sorted(p, x, cfg, groups=groups)
    raise ValueError(f"moe impl {impl!r} (want auto|dense|sorted)")
