"""The LM (the reference's ``models/lm.py``): the dense stack (GQA or MQA
attention, or MLA; a SwiGLU or GeLU MLP), the MoE stack, the
attention-free RWKV6 stack, the RecurrentGemma hybrid and the
encoder-decoder, with their forward, prefill and decode.

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

The encoder-decoder (``is_encoder_decoder``; seamless-m4t) keeps the
stacks ``encoder`` (``num_encoder_layers`` dense blocks) and ``decoder``
(``num_layers`` dense blocks, each with ``norm_x`` and a ``cross``
attention), stacked as ``layers`` is.  Its batch holds ``frames``, the
audio frontend's pre-computed embeddings ``(B, S, d)``: the encoder
attends over them bidirectionally, with sinusoidal positions added, and
the decoder's tokens (sinusoidal positions too, no RoPE) attend causally
to themselves and to the encoder's output.  A vision model
(``frontend="vision"``; llava) is the dense stack with the batch's
``frontend_embeds`` ``(B, F, d)`` prepended to its token embeddings,
positions running over both; its loss reads the last ``T`` positions.

Serving: ``init_cache`` builds the per-layer decode cache (KV caches
stacked on a layer axis for the dense stack, RWKV states likewise; for
the hybrid a list: ``h`` and ``conv`` per RG-LRU layer, an
``attn_window``-slot ring buffer per attention layer; for the
encoder-decoder ``{"self": the decoder's KV caches, "cross": {"k", "v"}
of the encoder's keys and values per decoder layer}``), ``prefill_step``
consumes a prompt (the encoder-decoder: encodes ``frames``, writes the
cross keys and values, and decodes BOS at position 0) and
``decode_step`` one token per sequence.  Both take ``impl`` (attention:
auto | naive | blocked | kernel) and ``rec_impl`` (the recurrences:
scan | kernel), and write the cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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
    ``attn_local`` by the pattern.  The encoder-decoder's blocks (both
    stacks) and a vision model's are ``dense``."""
    plain = cfg.recurrent is None and cfg.moe is None and cfg.mla is None \
        and cfg.mlp_kind in ("swiglu", "gelu")
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        # no other frontend is ported: it reaches the raise below
        if plain and (cfg.is_encoder_decoder or cfg.frontend == "vision"):
            return "dense"
    elif cfg.family in (FAMILY_DENSE, FAMILY_MOE) and cfg.recurrent is None:
        if cfg.moe is not None:
            return "moe"
        if cfg.mlp_kind in ("swiglu", "gelu"):
            return "dense"
    elif cfg.family == FAMILY_SSM and cfg.is_attention_free \
            and cfg.recurrent.kind == "rwkv6":
        return "rwkv"
    elif cfg.family == FAMILY_HYBRID and cfg.is_hybrid \
            and cfg.recurrent.kind == "rglru" \
            and cfg.mlp_kind in ("gelu", "swiglu"):
        return "rec" if cfg.layer_is_recurrent(layer_idx) else "attn_local"
    raise NotImplementedError(
        f"{cfg.name}: only the dense, MoE, RWKV6 and RecurrentGemma hybrid "
        f"stacks, the encoder-decoder of dense blocks and the vision "
        f"frontend on the dense stack are ported (family {cfg.family!r}, "
        f"recurrent {cfg.recurrent}, mlp {cfg.mlp_kind!r}, encoder-decoder "
        f"{cfg.is_encoder_decoder}, frontend {cfg.frontend!r})")


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

    def cross_block():
        # the reference's ``init_cross_block``: a dense block, then the
        # cross-attention's norm and projections
        p = block("dense")
        p["norm_x"] = L.init_norm(cfg, d, device)
        p["cross"] = A.init_attention(cfg, gen, device)
        return p

    def cast(tree):
        return tree if dtype == torch.float32 else \
            tree_map(lambda t: t.to(dtype), tree)

    def stacked(draw, n):
        # n layers drawn one at a time into stacks allocated up front
        leaves, treedef = tree_flatten(draw(0))
        out = [torch.empty((n,) + tuple(x.shape), dtype=dtype,
                           device=x.device) for x in leaves]
        for li in range(n):
            drawn = leaves if li == 0 else tree_flatten(draw(li))[0]
            for dst, x in zip(out, drawn):
                dst[li].copy_(x)
            del drawn
        del leaves
        return tree_unflatten(treedef, out)

    if cfg.is_hybrid:
        stack = {"blocks": [cast(block(kind)) for kind in kinds]}
    elif cfg.is_encoder_decoder:
        stack = {"encoder": stacked(lambda li: block("dense"),
                                    cfg.num_encoder_layers),
                 "decoder": stacked(lambda li: cross_block(),
                                    cfg.num_layers)}
    else:
        stack = {"layers": stacked(lambda li: block(kinds[li]),
                                   cfg.num_layers)}
    emb = {"table": cast(L.dense_init(gen, (cfg.vocab_size, d), device,
                                      scale=1.0))}
    if not cfg.tie_embeddings:
        emb["head"] = cast(L.dense_init(gen, (d, cfg.vocab_size), device))
    return {"embedding": emb, **stack,
            "final_norm": cast(L.init_norm(cfg, d, device))}


# The logical axes of every leaf (the reference's annotations: ``P(value,
# axes)`` at init, ``split_tree``'s axes twin), by the part of a block the
# leaf is in.  A stacked stack's leaves take "layers" first.
_NORM_AXES = {"scale": ("embed",), "bias": ("embed",)}
_PART_AXES = {
    "attention": {"wq": ("qkv", "heads", "head_dim"),
                  "wk": ("qkv", "kv_heads", "head_dim"),
                  "wv": ("qkv", "kv_heads", "head_dim"),
                  "wo": ("heads", "head_dim", "qkv"),
                  "q_norm": ("head_dim",), "k_norm": ("head_dim",)},
    "mla": {"wq": ("qkv", "heads", "head_dim"), "w_dkv": ("qkv", "lora"),
            "w_kr": ("qkv", "head_dim"), "kv_norm": ("lora",),
            "w_uk": ("lora", "heads", "head_dim"),
            "w_uv": ("lora", "heads", "head_dim"),
            "wo": ("heads", "head_dim", "qkv")},
    "mlp": {"wi": ("qkv", "ff"), "wg": ("qkv", "ff"), "wo": ("ff", "qkv")},
    "moe": {"router": ("qkv", "expert"),
            "wi": ("expert", "qkv", "expert_ff"),
            "wg": ("expert", "qkv", "expert_ff"),
            "wo": ("expert", "expert_ff", "qkv"),
            "shared_wi": ("qkv", "ff"), "shared_wg": ("qkv", "ff"),
            "shared_wo": ("ff", "qkv")},
    "time_mix": {"mu_x": ("embed",), "mu": (None, "embed"),
                 "mix_w1": ("qkv", "lora"), "mix_w2": (None, "lora", "embed"),
                 "decay_base": ("embed",), "decay_w1": ("qkv", "lora"),
                 "decay_w2": ("lora", "embed"),
                 "bonus_u": ("heads", "head_dim"), "wr": ("qkv", "ff"),
                 "wk": ("qkv", "ff"), "wv": ("qkv", "ff"),
                 "wg": ("qkv", "ff"), "wo": ("ff", "qkv"),
                 "ln_scale": ("embed",), "ln_bias": ("embed",)},
    "channel_mix": {"mu_k": ("embed",), "mu_r": ("embed",),
                    "wk": ("qkv", "ff"), "wv": ("ff", "qkv"),
                    "wr": ("qkv", "ff")},
    "rglru": {"w_in_x": ("qkv", "lru"), "w_in_g": ("qkv", "lru"),
              "conv_w": ("conv", "lru"), "conv_b": ("lru",),
              "gate_a_w": ("lru", "ff"), "gate_a_b": ("lru",),
              "gate_x_w": ("lru", "ff"), "gate_x_b": ("lru",),
              "lam": ("lru",), "w_out": ("lru", "qkv")},
}
_EMBED_AXES = {"table": ("vocab", "embed"), "head": ("embed", "vocab")}


def _block_axes(cfg: ModelConfig, kind: str, block: Dict, prefix: Tuple
                ) -> Dict:
    """The axes of one block's leaves (a stacked block's prefixed with
    ``prefix``)."""
    mixer = {"rwkv": "time_mix", "rec": "rglru"}.get(
        kind, "mla" if cfg.mla is not None else "attention")
    mlp = {"rwkv": "channel_mix", "moe": "moe"}.get(kind, "mlp")
    parts = {"mixer": _PART_AXES[mixer], "mlp": _PART_AXES[mlp],
             "cross": _PART_AXES["attention"]}
    return {part: {name: prefix + (parts[part][name] if part in parts
                                   else _NORM_AXES[name])
                   for name in leaves}
            for part, leaves in block.items()}


def param_axes(cfg: ModelConfig) -> Params:
    """The logical axes of every leaf of ``init_lm(cfg, ...)``, a tree of
    its structure with one tuple of axis names (None: an unnamed axis) a
    leaf: the reference's ``init_lm`` axes twin, in the port's tree
    order.  Built from the tree's shapes on the ``meta`` device, so
    nothing is allocated."""
    tree = init_lm(cfg, 0, "meta")
    out: Params = {"embedding": {k: _EMBED_AXES[k] for k in tree["embedding"]},
                   "final_norm": {k: _NORM_AXES[k]
                                  for k in tree["final_norm"]}}
    if "blocks" in tree:
        out["blocks"] = [_block_axes(cfg, block_kind(cfg, i), b, ())
                         for i, b in enumerate(tree["blocks"])]
    for stack in ("layers", "encoder", "decoder"):
        if stack in tree:
            out[stack] = _block_axes(cfg, block_kind(cfg, 0), tree[stack],
                                     ("layers",))
    return out


# rec_impl -> the RG-LRU block's impl (the reference's names)
_RGLRU_IMPL = {"scan": "seq", "kernel": "kernel"}


def _cross_kv(p, enc_out: torch.Tensor):
    """The cross-attention's keys and values ``(B, Senc, K, hd)`` of the
    encoder's output: no RoPE, no qk-norm (the reference's ``_cross_kv``)."""
    dt = enc_out.dtype
    return (torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(dt)),
            torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(dt)))


def apply_block(p, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
                positions: torch.Tensor, impl: str = "auto",
                rec_impl: str = "scan", moe_impl: str = "auto", cache=None,
                pos: Optional[int] = None, causal: bool = True,
                cross_kv=None):
    """One pre-norm residual block.  With a ``cache`` and a start ``pos``
    it is stateful (prefill or decode).  ``causal=False`` is the
    encoder's self-attention.  A decoder block of the encoder-decoder
    (``cross`` in ``p``) then attends to ``cross_kv``, the encoder's keys
    and values (``_cross_kv`` in the forward, the cross cache in decode).
    Returns ``(x, new_cache)``."""
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
                                  causal=causal, window=window, impl=impl)
    x = x + h
    if "cross" in p:
        hx = L.apply_norm(p["norm_x"], x)
        x = x + A.apply_attention(p["cross"], hx, cfg, positions=positions,
                                  kv=cross_kv, impl=impl)
    h2 = L.apply_norm(p["norm2"], x)
    if kind == "moe":
        return x + M.apply_moe(p["mlp"], h2, cfg, impl=moe_impl), new_cache
    return x + L.apply_mlp(p["mlp"], h2, cfg.mlp_kind), new_cache


def _unstack(stack, n: int):
    """Per-layer views of a stacked tree, layer by layer."""
    leaves, treedef = tree_flatten(stack)
    per_leaf = [torch.unbind(leaf) for leaf in leaves]
    for li in range(n):
        yield tree_unflatten(treedef, [u[li] for u in per_leaf])


def _layers(params, cfg: ModelConfig):
    """Each layer's index, kind and parameters (views of the stacked tree,
    or the hybrid's per-layer dicts); the encoder-decoder's decoder
    layers."""
    if cfg.is_hybrid:
        for li, lp in enumerate(params["blocks"]):
            yield li, block_kind(cfg, li), lp
        return
    kind = block_kind(cfg)
    stack = params["decoder" if cfg.is_encoder_decoder else "layers"]
    for li, lp in enumerate(_unstack(stack, cfg.num_layers)):
        yield li, kind, lp


def _batch(tokens_or_batch) -> Dict[str, torch.Tensor]:
    if isinstance(tokens_or_batch, torch.Tensor):
        return {"tokens": tokens_or_batch}
    return tokens_or_batch


def _with_positions(x: torch.Tensor) -> torch.Tensor:
    """``x (B, S, d)`` plus the sinusoidal positions ``0..S-1``, in x's
    dtype (the reference's numpy table)."""
    table = L.sinusoidal_positions(x.shape[1], x.shape[-1])
    return x + torch.from_numpy(table).to(x.device, x.dtype)


def _encode(params, frames: torch.Tensor, cfg: ModelConfig, *, impl: str,
            remat: bool = False) -> torch.Tensor:
    """The encoder: ``frames (B, S, d)`` plus sinusoidal positions, through
    the bidirectional stack -> ``(B, S, d)`` in the compute dtype."""
    x = _with_positions(frames.to(L.compute_dtype(cfg)))
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in _unstack(params["encoder"], cfg.num_encoder_layers):
        def layer(lp, x):
            return apply_block(lp, x, cfg, kind="dense", positions=positions,
                               impl=impl, causal=False)[0]
        x = checkpoint(layer, lp, x, use_reentrant=False) if remat \
            else layer(lp, x)
    return x


def _embed_inputs(params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> torch.Tensor:
    """The token embeddings, after a vision model's ``frontend_embeds``
    when the batch has them."""
    dt = L.compute_dtype(cfg)
    x = L.embed(params["embedding"], batch["tokens"], dt)
    if cfg.frontend != "none" and "frontend_embeds" in batch:
        x = torch.cat([batch["frontend_embeds"].to(dt), x], dim=1)
    return x


def lm_forward(params, tokens, cfg: ModelConfig, *, impl: str = "auto",
               rec_impl: str = "scan", moe_impl: str = "auto"
               ) -> torch.Tensor:
    """tokens (B, S) int64, or the reference's batch (``tokens``, with
    ``frames`` for the encoder-decoder or ``frontend_embeds`` for a vision
    model) -> logits (B, S, V) in the compute dtype (the decoder's for the
    encoder-decoder; over the embeddings and the tokens for a vision
    model).  With ``cfg.remat`` and autograd on, each layer's
    activations are recomputed in the backward instead of kept."""
    batch = _batch(tokens)
    remat = cfg.remat and torch.is_grad_enabled()
    x, enc_out = _embed_inputs(params, batch, cfg), None
    if cfg.is_encoder_decoder:
        enc_out = _encode(params, batch["frames"], cfg, impl=impl,
                          remat=remat)
        x = _with_positions(x)
    positions = torch.arange(x.shape[1], device=x.device)
    for _, kind, lp in _layers(params, cfg):
        def layer(lp, x, enc_out, kind=kind):
            # inside the checkpointed function, so remat recomputes the
            # cross keys and values too
            cross_kv = None if enc_out is None \
                else _cross_kv(lp["cross"], enc_out)
            return apply_block(lp, x, cfg, kind=kind, positions=positions,
                               impl=impl, rec_impl=rec_impl,
                               moe_impl=moe_impl, cross_kv=cross_kv)[0]
        x = checkpoint(layer, lp, x, enc_out, use_reentrant=False) if remat \
            else layer(lp, x, enc_out)
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
    """The mean cross-entropy of ``batch["targets"]``; where the frontend's
    positions precede the tokens, the logits' last ``T`` positions are
    the targets'."""
    logits = lm_forward(params, batch, cfg, impl=impl, moe_impl=moe_impl)
    targets = batch["targets"]
    if logits.shape[1] != targets.shape[1]:
        logits = logits[:, -targets.shape[1]:]
    return cross_entropy(logits, targets)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               enc_len: int = 0, dtype=torch.bfloat16, device="cuda"):
    """The per-layer decode cache, on the card unless ``device`` names the
    CPU.  Stacked on a leading layer axis: a KV
    cache of ``max_len`` slots per dense or MoE layer (MLA: its latent and
    RoPE key), the WKV state and last tokens per RWKV6 layer.  For the hybrid, a list: ``h`` (fp32) and
    the conv tail per RG-LRU layer, a ring buffer of ``min(max_len,
    attn_window)`` slots per attention layer.  For the encoder-decoder,
    ``{"self": the decoder layers' KV caches, "cross": {"k", "v"}}``, the
    cross keys and values ``(num_layers, batch, enc_len, K, hd)`` that
    the prefill fills."""
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
    stacked = tree_map(
        lambda x: x[None].repeat((cfg.num_layers,) + (1,) * x.ndim), one)
    if not cfg.is_encoder_decoder:
        return stacked
    shape = (cfg.num_layers, batch, enc_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"self": stacked,
            "cross": {name: torch.zeros(shape, dtype=dtype, device=device)
                      for name in ("k", "v")}}


def _stateful_stack(params, cache, x, cfg: ModelConfig, *, pos: int,
                    impl: str, rec_impl: str, moe_impl: str):
    """Run every layer statefully from ``pos``; each layer's new cache is
    written into its part of the cache (its slice of the stacked cache,
    or the hybrid's per-layer dict).  The encoder-decoder's decoder
    layers read their cross keys and values from ``cache["cross"]``."""
    positions = torch.arange(pos, pos + x.shape[1], device=x.device)
    cross = None
    if cfg.is_encoder_decoder:
        cross, cache = cache["cross"], cache["self"]
    for li, kind, lp in _layers(params, cfg):
        layer_cache = cache[li] if isinstance(cache, list) else \
            {name: t[li] for name, t in cache.items()}
        x, new = apply_block(
            lp, x, cfg, kind=kind, positions=positions, impl=impl,
            rec_impl=rec_impl, moe_impl=moe_impl, cache=layer_cache,
            pos=pos, cross_kv=None if cross is None
            else (cross["k"][li], cross["v"][li]))
        for name, t in new.items():
            if t is not layer_cache[name]:
                layer_cache[name].copy_(t)
    return x


def prefill_step(params, cache, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, *, impl: str = "auto",
                 rec_impl: str = "scan", moe_impl: str = "auto"):
    """Consume the prompt ``batch["tokens"]`` (B, T) from position 0 (a
    vision model: after ``batch["frontend_embeds"]`` (B, F, d), positions
    0..F+T-1), write the cache, return the last position's logits (B, 1,
    V) and the cache.  The encoder-decoder encodes ``batch["frames"]``
    (B, S, d), writes each decoder layer's cross keys and values into
    ``cache["cross"]`` (``enc_len == S``), then decodes BOS (token 0) at
    position 0: its logits are the first token's."""
    if cfg.is_encoder_decoder:
        frames = batch["frames"]
        cross = cache["cross"]
        if cross["k"].shape[2] != frames.shape[1]:
            raise ValueError(f"prefill_step: {frames.shape[1]} frames into "
                             f"a cross cache of {cross['k'].shape[2]}")
        enc_out = _encode(params, frames, cfg, impl=impl)
        for li, _, lp in _layers(params, cfg):
            k, v = _cross_kv(lp["cross"], enc_out)
            cross["k"][li].copy_(k)
            cross["v"][li].copy_(v)
        bos = torch.zeros((frames.shape[0], 1), dtype=torch.int64,
                          device=frames.device)
        return decode_step(params, cache, bos, 0, cfg, impl=impl,
                           rec_impl=rec_impl, moe_impl=moe_impl)
    x = _embed_inputs(params, batch, cfg)
    x = _stateful_stack(params, cache, x, cfg, pos=0, impl=impl,
                        rec_impl=rec_impl, moe_impl=moe_impl)
    x = L.apply_norm(params["final_norm"], x[:, -1:])
    return L.unembed(params["embedding"], x), cache


def decode_step(params, cache, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig, *, impl: str = "auto",
                rec_impl: str = "scan", moe_impl: str = "auto"):
    """One token per sequence: tokens (B, 1) at absolute position ``pos``
    -> logits (B, 1, V) and the cache.  The encoder-decoder adds the
    sinusoidal embedding of ``pos`` (computed in torch fp32, as the
    reference's ``sinusoidal_at``)."""
    pos = int(pos)
    dt = L.compute_dtype(cfg)
    x = L.embed(params["embedding"], tokens, dt)
    if cfg.is_encoder_decoder:
        at = torch.tensor([pos], dtype=torch.int32, device=x.device)
        x = x + L.sinusoidal_at(at, cfg.d_model).to(dt)
    x = _stateful_stack(params, cache, x, cfg, pos=pos, impl=impl,
                        rec_impl=rec_impl, moe_impl=moe_impl)
    x = L.apply_norm(params["final_norm"], x)
    return L.unembed(params["embedding"], x), cache
