"""The decoder LM (the reference's ``models/lm.py``): the dense stack (GQA
or MQA attention, or MLA; a SwiGLU or GeLU MLP), the MoE stack, the
attention-free RWKV6 stack and the RecurrentGemma hybrid, with their
forward, prefill and decode.

``init_lm`` returns the reference's parameter tree: ``embedding.{table,
head}``, ``final_norm``, and the blocks.  The dense, MoE and RWKV6 stacks
keep ``layers.{norm1,mixer,norm2,mlp}`` with every layer leaf stacked on
a leading ``(num_layers,)`` axis, and the forward walks them in a Python
loop over ``torch.unbind`` views, so the backward stacks each leaf's
layer grads once.  The hybrid keeps a list ``blocks`` of per-layer dicts,
RG-LRU (``rec``) and local attention (``attn_local``) blocks by the
config's ``block_pattern``, each with a GeLU MLP.  A config with ``mla``
takes the MLA mixer, one with ``moe`` the MoE block in place of the MLP
(``moe_impl``: auto | dense | sorted, the reference's).  With
``cfg.remat`` the training forward recomputes each layer in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).

Serving: ``init_cache`` builds the per-layer decode cache (KV caches
stacked on a layer axis for the dense stack, RWKV states likewise, and
for the hybrid a list: ``h`` and ``conv`` per RG-LRU layer, an
``attn_window``-slot ring buffer per attention layer), ``prefill_step``
consumes a prompt and ``decode_step`` one token per sequence.  Both take
``impl`` (attention: auto | naive | blocked | kernel) and ``rec_impl``
(the recurrences: scan | kernel), and write
the cache in place.  The reference's encoder-decoder and its modality
frontends raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device

from repro_torch.config import (
    FAMILY_DENSE, FAMILY_HYBRID, FAMILY_MOE, FAMILY_SSM, ModelConfig,
)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as G
from repro_torch.models import rwkv as R
from repro_torch.utils.trees import tree_flatten, tree_map, tree_unflatten

Params = Dict


def block_kind(cfg: ModelConfig, layer_idx: int = 0) -> str:
    """``dense``, ``moe``, ``rwkv``, or for the hybrid ``rec`` /
    ``attn_local`` by the pattern; the encoder-decoder and the modality
    frontends are not ported."""
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder and the modality frontends are "
            f"not ported (ROADMAP queue 1 item 7)")
    if cfg.family in (FAMILY_DENSE, FAMILY_MOE) and cfg.recurrent is None:
        if cfg.moe is not None:
            return "moe"
        if cfg.mlp_kind in ("swiglu", "gelu"):
            return "dense"
    if cfg.family == FAMILY_SSM and cfg.is_attention_free \
            and cfg.recurrent.kind == "rwkv6":
        return "rwkv"
    if cfg.family == FAMILY_HYBRID and cfg.is_hybrid \
            and cfg.recurrent.kind == "rglru" \
            and cfg.mlp_kind in ("gelu", "swiglu"):
        return "rec" if cfg.layer_is_recurrent(layer_idx) else "attn_local"
    raise NotImplementedError(
        f"{cfg.name}: only the dense, MoE, RWKV6 and RecurrentGemma hybrid "
        f"stacks are ported (family {cfg.family!r}, recurrent "
        f"{cfg.recurrent}, mlp {cfg.mlp_kind!r})")


def init_lm(cfg: ModelConfig, seed: int, device,
            draw_on: Optional[torch.device] = None,
            dtype: torch.dtype = torch.float32) -> Params:
    """Random init with the reference's shapes and scales (``dense_init``;
    the embedding table at scale 1), stored in ``dtype``.  The generator
    draws on ``draw_on``, the CPU by default so one seed gives one model
    on every device; a multi-billion-parameter model draws on its card
    instead.  The draws are fp32, layer after layer, each layer's leaves
    copied into stacks allocated up front, so the peak is the tree in
    ``dtype`` plus one layer's fp32 draws.  The bits differ from
    ``jax.random``: parity tests start both sides from one init through
    ``bridge``."""
    cfg.validate()
    kinds = [block_kind(cfg, i) for i in range(cfg.num_layers)]
    gen = torch.Generator(device=draw_on or "cpu").manual_seed(int(seed))
    d = cfg.d_model

    def block(kind):
        p = {"norm1": L.init_norm(cfg, d, device),
             "norm2": L.init_norm(cfg, d, device)}
        if kind == "rwkv":
            p["mixer"] = R.init_time_mix(cfg, gen, device)
            p["mlp"] = R.init_channel_mix(cfg, gen, device)
            return p
        if kind == "rec":
            p["mixer"] = G.init_rglru_block(cfg, gen, device)
        elif cfg.mla is not None:
            p["mixer"] = A.init_mla(cfg, gen, device)
        else:
            p["mixer"] = A.init_attention(cfg, gen, device)
        p["mlp"] = M.init_moe(cfg, gen, device) if kind == "moe" \
            else L.init_mlp(cfg, gen, device)
        return p

    def cast(tree):
        return tree if dtype == torch.float32 else \
            tree_map(lambda t: t.to(dtype), tree)

    if cfg.is_hybrid:
        stack = {"blocks": [cast(block(kind)) for kind in kinds]}
    else:
        first = block(kinds[0])
        leaves, treedef = tree_flatten(first)
        stacked = [torch.empty((cfg.num_layers,) + tuple(x.shape),
                               dtype=dtype, device=x.device) for x in leaves]
        for li in range(cfg.num_layers):
            drawn = leaves if li == 0 else tree_flatten(block(kinds[li]))[0]
            for dst, x in zip(stacked, drawn):
                dst[li].copy_(x)
            del drawn
        del first, leaves
        stack = {"layers": tree_unflatten(treedef, stacked)}
    emb = {"table": cast(L.dense_init(gen, (cfg.vocab_size, d), device,
                                      scale=1.0))}
    if not cfg.tie_embeddings:
        emb["head"] = cast(L.dense_init(gen, (d, cfg.vocab_size), device))
    return {"embedding": emb, **stack,
            "final_norm": cast(L.init_norm(cfg, d, device))}


# rec_impl -> the RG-LRU block's impl (the reference's names)
_RGLRU_IMPL = {"scan": "seq", "kernel": "kernel"}


def apply_block(p, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
                positions: torch.Tensor, impl: str = "auto",
                rec_impl: str = "scan", moe_impl: str = "auto", cache=None,
                pos: Optional[int] = None):
    """One pre-norm residual block.  With a ``cache`` and a start ``pos``
    it is stateful (prefill or decode).  Returns ``(x, new_cache)``."""
    h = L.apply_norm(p["norm1"], x)
    decode = cache is not None and pos is not None
    new_cache = cache
    if kind == "rwkv":
        h, tm_state = R.apply_time_mix(p["mixer"], h, cfg,
                                       state=cache if decode else None,
                                       impl=rec_impl)
        x = x + h
        h2 = L.apply_norm(p["norm2"], x)
        h2, cm_state = R.apply_channel_mix(p["mlp"], h2,
                                           state=cache if decode else None)
        if decode:
            new_cache = {**tm_state, **cm_state}
        return x + h2, new_cache
    if kind == "rec":
        if rec_impl not in _RGLRU_IMPL:
            raise ValueError(f"rec_impl {rec_impl!r} (want scan|kernel)")
        h, rec_state = G.apply_rglru_block(p["mixer"], h, cfg,
                                           state=cache if decode else None,
                                           impl=_RGLRU_IMPL[rec_impl])
        if decode:
            new_cache = rec_state
    elif cfg.mla is not None:
        if decode:
            h, new_cache = A.decode_mla(p["mixer"], h, cache, cfg, pos=pos,
                                        impl=impl)
        else:
            h = A.apply_mla(p["mixer"], h, cfg, positions=positions,
                            impl=impl)
    else:
        # the reference's rule: only a hybrid's local-attention block
        # takes the window
        window = cfg.attn_window if kind == "attn_local" else 0
        if decode:
            h, new_cache = A.decode_attention(p["mixer"], h, cache, cfg,
                                              pos=pos, window=window,
                                              impl=impl)
        else:
            h = A.apply_attention(p["mixer"], h, cfg, positions=positions,
                                  window=window, impl=impl)
    x = x + h
    h2 = L.apply_norm(p["norm2"], x)
    if kind == "moe":
        return x + M.apply_moe(p["mlp"], h2, cfg, impl=moe_impl), new_cache
    return x + L.apply_mlp(p["mlp"], h2, cfg.mlp_kind), new_cache


def _layers(params, cfg: ModelConfig):
    """Each layer's index, kind and parameters (views of the stacked tree,
    or the hybrid's per-layer dicts)."""
    if cfg.is_hybrid:
        for li, lp in enumerate(params["blocks"]):
            yield li, block_kind(cfg, li), lp
        return
    kind = block_kind(cfg)
    leaves, treedef = tree_flatten(params["layers"])
    per_leaf = [torch.unbind(leaf) for leaf in leaves]
    for li in range(cfg.num_layers):
        yield li, kind, tree_unflatten(treedef, [u[li] for u in per_leaf])


def lm_forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
               impl: str = "auto", rec_impl: str = "scan",
               moe_impl: str = "auto") -> torch.Tensor:
    """tokens (B, S) int64 -> logits (B, S, V) in the compute dtype.  With
    ``cfg.remat`` and autograd on, each layer's activations are recomputed
    in the backward instead of kept."""
    x = L.embed(params["embedding"], tokens, L.compute_dtype(cfg))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for _, kind, lp in _layers(params, cfg):
        def layer(lp, x, kind=kind):
            return apply_block(lp, x, cfg, kind=kind, positions=positions,
                               impl=impl, rec_impl=rec_impl,
                               moe_impl=moe_impl)[0]
        x = checkpoint(layer, lp, x, use_reentrant=False) if remat \
            else layer(lp, x)
    x = L.apply_norm(params["final_norm"], x)
    return L.unembed(params["embedding"], x)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over targets >= 0, in fp32 (the reference's
    ``_fused_ce`` forward; its hand-written backward is autograd's here)."""
    logits = logits.to(torch.float32)
    mask = (targets >= 0).to(torch.float32)
    tgt = torch.clamp(targets, min=0)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, tgt[..., None])[..., 0]
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum((lse - ll) * mask) / denom


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            impl: str = "auto", moe_impl: str = "auto") -> torch.Tensor:
    logits = lm_forward(params, batch["tokens"], cfg, impl=impl,
                        moe_impl=moe_impl)
    return cross_entropy(logits, batch["targets"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda"):
    """The per-layer decode cache, on the card unless ``device`` names the
    CPU.  Stacked on a leading layer axis: a KV
    cache of ``max_len`` slots per dense or MoE layer (MLA: its latent and
    RoPE key), the WKV state and last tokens per RWKV6 layer.  For the hybrid, a list: ``h`` (fp32) and
    the conv tail per RG-LRU layer, a ring buffer of ``min(max_len,
    attn_window)`` slots per attention layer."""
    device = resolve_device(device)
    kinds = [block_kind(cfg, i) for i in range(cfg.num_layers)]
    if cfg.is_hybrid:
        return [G.init_rglru_state(cfg, batch, dtype, device) if k == "rec"
                else A.init_kv_cache(cfg, batch, max_len,
                                     window=cfg.attn_window, dtype=dtype,
                                     device=device) for k in kinds]
    if kinds[0] == "rwkv":
        one = R.init_rwkv_state(cfg, batch, dtype, device)
    elif cfg.mla is not None:
        one = A.init_mla_cache(cfg, batch, max_len, dtype=dtype,
                               device=device)
    else:
        one = A.init_kv_cache(cfg, batch, max_len, dtype=dtype,
                              device=device)
    return tree_map(
        lambda x: x[None].repeat((cfg.num_layers,) + (1,) * x.ndim), one)


def _stateful_stack(params, cache, x, cfg: ModelConfig, *, pos: int,
                    impl: str, rec_impl: str, moe_impl: str):
    """Run every layer statefully from ``pos``; each layer's new cache is
    written into its part of the cache (its slice of the stacked cache,
    or the hybrid's per-layer dict)."""
    positions = torch.arange(pos, pos + x.shape[1], device=x.device)
    for li, kind, lp in _layers(params, cfg):
        layer_cache = cache[li] if isinstance(cache, list) else \
            {name: t[li] for name, t in cache.items()}
        x, new = apply_block(lp, x, cfg, kind=kind, positions=positions,
                             impl=impl, rec_impl=rec_impl, moe_impl=moe_impl,
                             cache=layer_cache, pos=pos)
        for name, t in new.items():
            if t is not layer_cache[name]:
                layer_cache[name].copy_(t)
    return x


def prefill_step(params, cache, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, *, impl: str = "auto",
                 rec_impl: str = "scan", moe_impl: str = "auto"):
    """Consume the prompt ``batch["tokens"]`` (B, T) from position 0, write
    the cache, return the last position's logits (B, 1, V) and the
    cache."""
    tokens = batch["tokens"]
    x = L.embed(params["embedding"], tokens, L.compute_dtype(cfg))
    x = _stateful_stack(params, cache, x, cfg, pos=0, impl=impl,
                        rec_impl=rec_impl, moe_impl=moe_impl)
    x = L.apply_norm(params["final_norm"], x[:, -1:])
    return L.unembed(params["embedding"], x), cache


def decode_step(params, cache, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig, *, impl: str = "auto",
                rec_impl: str = "scan", moe_impl: str = "auto"):
    """One token per sequence: tokens (B, 1) at absolute position ``pos``
    -> logits (B, 1, V) and the cache."""
    x = L.embed(params["embedding"], tokens, L.compute_dtype(cfg))
    x = _stateful_stack(params, cache, x, cfg, pos=int(pos), impl=impl,
                        rec_impl=rec_impl, moe_impl=moe_impl)
    x = L.apply_norm(params["final_norm"], x)
    return L.unembed(params["embedding"], x), cache
