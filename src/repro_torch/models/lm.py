"""The decoder LM (the reference's ``models/lm.py``): the dense GQA stack
and the attention-free RWKV6 stack, with their forward, prefill and
decode.

``init_lm`` returns the reference's parameter tree: ``embedding.{table,
head}``, ``layers.{norm1,mixer,norm2,mlp}`` with every layer leaf stacked
on a leading ``(num_layers,)`` axis, and ``final_norm``.  The forward walks
the layer stack in a Python loop over ``torch.unbind`` views, so the
backward stacks each leaf's layer grads once.

Serving: ``init_cache`` builds the stacked per-layer cache (KV caches for
the dense stack, RWKV states for the RWKV6 stack), ``prefill_step``
consumes a prompt and ``decode_step`` one token per sequence.  Both take
``impl`` (attention: auto | naive | blocked | kernel) and ``rec_impl``
(WKV: scan | kernel), and write the cache in place.  The other
families of the reference (MoE / MLA, the RecurrentGemma hybrid, the
encoder-decoder, the VLM frontend) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.config import FAMILY_DENSE, FAMILY_SSM, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.utils.trees import tree_flatten, tree_map, tree_unflatten

Params = Dict


def block_kind(cfg: ModelConfig) -> str:
    """``dense`` or ``rwkv``; the reference's other block kinds are not
    ported."""
    if cfg.family == FAMILY_DENSE and cfg.recurrent is None \
            and cfg.mlp_kind == "swiglu":
        return "dense"
    if cfg.family == FAMILY_SSM and cfg.is_attention_free \
            and cfg.recurrent.kind == "rwkv6":
        return "rwkv"
    raise NotImplementedError(
        f"{cfg.name}: only the dense GQA and the RWKV6 stacks are ported "
        f"(family {cfg.family!r}, recurrent {cfg.recurrent})")


def init_lm(cfg: ModelConfig, seed: int, device,
            draw_on: Optional[torch.device] = None) -> Params:
    """Random init with the reference's shapes and scales (``dense_init``;
    the embedding table at scale 1).  The generator draws on ``draw_on``,
    the CPU by default so one seed gives one model on every device; a
    multi-billion-parameter model draws on its card instead.  The bits
    differ from ``jax.random``: parity tests start both sides from one
    init through ``bridge``."""
    cfg.validate()
    kind = block_kind(cfg)
    gen = torch.Generator(device=draw_on or "cpu").manual_seed(int(seed))
    d, f = cfg.d_model, cfg.d_ff

    def block():
        p = {"norm1": L.init_norm(cfg, d, device),
             "norm2": L.init_norm(cfg, d, device)}
        if kind == "rwkv":
            p["mixer"] = R.init_time_mix(cfg, gen, device)
            p["mlp"] = R.init_channel_mix(cfg, gen, device)
        else:
            p["mixer"] = A.init_attention(cfg, gen, device)
            p["mlp"] = {"wi": L.dense_init(gen, (d, f), device),
                        "wg": L.dense_init(gen, (d, f), device),
                        "wo": L.dense_init(gen, (f, d), device)}
        return p

    blocks = [block() for _ in range(cfg.num_layers)]
    layers = tree_map(lambda *xs: torch.stack(xs), *blocks)
    emb = {"table": L.dense_init(gen, (cfg.vocab_size, d), device, scale=1.0)}
    if not cfg.tie_embeddings:
        emb["head"] = L.dense_init(gen, (d, cfg.vocab_size), device)
    return {"embedding": emb, "layers": layers,
            "final_norm": L.init_norm(cfg, d, device)}


def apply_block(p, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
                positions: torch.Tensor, impl: str = "auto",
                rec_impl: str = "scan", cache=None,
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
    window = cfg.attn_window
    if decode:
        h, new_cache = A.decode_attention(p["mixer"], h, cache, cfg, pos=pos,
                                          window=window, impl=impl)
    else:
        h = A.apply_attention(p["mixer"], h, cfg, positions=positions,
                              window=window, impl=impl)
    x = x + h
    h2 = L.apply_norm(p["norm2"], x)
    return x + L.apply_mlp(p["mlp"], h2), new_cache


def _layers(params, cfg: ModelConfig):
    """Per-layer parameter views of the stacked tree."""
    leaves, treedef = tree_flatten(params["layers"])
    per_leaf = [torch.unbind(leaf) for leaf in leaves]
    for li in range(cfg.num_layers):
        yield li, tree_unflatten(treedef, [u[li] for u in per_leaf])


def lm_forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
               impl: str = "auto", rec_impl: str = "scan") -> torch.Tensor:
    """tokens (B, S) int64 -> logits (B, S, V) in the compute dtype."""
    kind = block_kind(cfg)
    x = L.embed(params["embedding"], tokens, L.compute_dtype(cfg))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for _, lp in _layers(params, cfg):
        x, _ = apply_block(lp, x, cfg, kind=kind, positions=positions,
                           impl=impl, rec_impl=rec_impl)
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
            impl: str = "auto") -> torch.Tensor:
    logits = lm_forward(params, batch["tokens"], cfg, impl=impl)
    return cross_entropy(logits, batch["targets"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cpu") -> Dict:
    """The per-layer decode cache, stacked on a leading layer axis: a KV
    cache of ``max_len`` slots (``attn_window`` slots as a ring buffer)
    per dense layer, the WKV state and last tokens per RWKV6 layer."""
    kind = block_kind(cfg)
    if kind == "rwkv":
        one = R.init_rwkv_state(cfg, batch, dtype, device)
    else:
        one = A.init_kv_cache(cfg, batch, max_len, window=cfg.attn_window,
                              dtype=dtype, device=device)
    return tree_map(
        lambda x: x[None].repeat((cfg.num_layers,) + (1,) * x.ndim), one)


def _stateful_stack(params, cache, x, cfg: ModelConfig, *, pos: int,
                    impl: str, rec_impl: str):
    """Run every layer statefully from ``pos``; each layer's new cache is
    written into its slice of the stacked cache."""
    kind = block_kind(cfg)
    positions = torch.arange(pos, pos + x.shape[1], device=x.device)
    for li, lp in _layers(params, cfg):
        layer_cache = {name: t[li] for name, t in cache.items()}
        x, new = apply_block(lp, x, cfg, kind=kind, positions=positions,
                             impl=impl, rec_impl=rec_impl,
                             cache=layer_cache, pos=pos)
        for name, t in new.items():
            if t is not layer_cache[name]:
                cache[name][li].copy_(t)
    return x


def prefill_step(params, cache, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, *, impl: str = "auto",
                 rec_impl: str = "scan"):
    """Consume the prompt ``batch["tokens"]`` (B, T) from position 0, write
    the cache, return the last position's logits (B, 1, V) and the
    cache."""
    tokens = batch["tokens"]
    x = L.embed(params["embedding"], tokens, L.compute_dtype(cfg))
    x = _stateful_stack(params, cache, x, cfg, pos=0, impl=impl,
                        rec_impl=rec_impl)
    x = L.apply_norm(params["final_norm"], x[:, -1:])
    return L.unembed(params["embedding"], x), cache


def decode_step(params, cache, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig, *, impl: str = "auto",
                rec_impl: str = "scan"):
    """One token per sequence: tokens (B, 1) at absolute position ``pos``
    -> logits (B, 1, V) and the cache."""
    x = L.embed(params["embedding"], tokens, L.compute_dtype(cfg))
    x = _stateful_stack(params, cache, x, cfg, pos=int(pos), impl=impl,
                        rec_impl=rec_impl)
    x = L.apply_norm(params["final_norm"], x)
    return L.unembed(params["embedding"], x), cache
