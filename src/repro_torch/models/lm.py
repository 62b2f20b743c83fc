"""The dense GQA decoder LM (the reference's ``models/lm.py`` dense path).

``init_lm`` returns the reference's parameter tree: ``embedding.{table,
head}``, ``layers.{norm1,mixer,norm2,mlp}`` with every layer leaf stacked
on a leading ``(num_layers,)`` axis, and ``final_norm``.  The forward walks
the layer stack in a Python loop over ``torch.unbind`` views, so the
backward stacks each leaf's layer grads once.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.utils.trees import tree_flatten, tree_map, tree_unflatten

Params = Dict


def init_lm(cfg: ModelConfig, seed: int, device) -> Params:
    """Random init with the reference's shapes and scales (``dense_init``;
    the embedding table at scale 1), drawn on the CPU and moved to
    ``device``, so one seed gives one model on every device.  The bits
    differ from ``jax.random``: parity tests start both sides from one
    init through ``bridge``."""
    cfg.validate()
    gen = torch.Generator().manual_seed(int(seed))
    d, f = cfg.d_model, cfg.d_ff

    def block():
        return {
            "norm1": {"scale": torch.ones((d,), device=device)},
            "mixer": A.init_attention(cfg, gen, device),
            "norm2": {"scale": torch.ones((d,), device=device)},
            "mlp": {"wi": L.dense_init(gen, (d, f), device),
                    "wg": L.dense_init(gen, (d, f), device),
                    "wo": L.dense_init(gen, (f, d), device)},
        }

    blocks = [block() for _ in range(cfg.num_layers)]
    emb = {"table": L.dense_init(gen, (cfg.vocab_size, d), device, scale=1.0)}
    if not cfg.tie_embeddings:
        emb["head"] = L.dense_init(gen, (d, cfg.vocab_size), device)
    return {
        "embedding": emb,
        "layers": tree_map(lambda *xs: torch.stack(xs), *blocks),
        "final_norm": {"scale": torch.ones((d,), device=device)},
    }


def apply_block(p, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """One pre-norm residual block (attention, then SwiGLU)."""
    h = L.rms_norm(x, p["norm1"]["scale"])
    x = x + A.apply_attention(p["mixer"], h, cfg, positions=positions,
                              impl=impl)
    h2 = L.rms_norm(x, p["norm2"]["scale"])
    return x + L.apply_mlp(p["mlp"], h2)


def lm_forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
               impl: str = "auto") -> torch.Tensor:
    """tokens (B, S) int64 -> logits (B, S, V) fp32."""
    x = L.embed(params["embedding"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    leaves, treedef = tree_flatten(params["layers"])
    per_leaf = [torch.unbind(leaf) for leaf in leaves]
    for li in range(cfg.num_layers):
        lp = tree_unflatten(treedef, [u[li] for u in per_leaf])
        x = apply_block(lp, x, cfg, positions=positions, impl=impl)
    x = L.rms_norm(x, params["final_norm"]["scale"])
    return L.unembed(params["embedding"], x)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over targets >= 0 (the reference's ``_fused_ce``
    forward; its hand-written backward is autograd's here)."""
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
