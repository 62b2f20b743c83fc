"""Batched serving: prefill a prompt batch, then decode greedily (the
reference's ``launch/serve.py``).

On a card, prefill and decode run attention (GQA and MLA) through the
flash-attention kernels, the RWKV6 time-mix through the WKV6 kernel and
the RG-LRU through its kernel (``impl="kernel"``, ``rec_impl="kernel"``);
on the CPU the same calls take the kernels' plain versions.  The MoE
block takes ``moe_impl`` (auto: dense at 512 tokens or fewer, else
sorted).  Parameters are fp32, as in the reference's ``serve``
(``launch/steps.py`` holds them in bf16 instead).  The encoder-decoder's
prompt is ``prompt_len`` frames of its frontend's embeddings (normal
draws of ``default_rng(seed)``, as the reference's): the prefill encodes
them and decodes BOS at position 0, and decode goes on from position 1.
A vision model is served from tokens alone, as the reference's ``serve``
does (``launch/steps.py``'s prefill takes its patch embeddings).

    python -m repro_torch.launch.serve --preset lmtiny --device cpu
    python -m repro_torch.launch.serve --preset recurrentgemma-2b \
        --device cpu --prompt-len 40
    python -m repro_torch.launch.serve --preset lm100m --batch 8 \
        --prompt-len 512 --gen 64
    python -m repro_torch.launch.serve --arch rwkv6-3b --batch 4 \
        --prompt-len 256 --gen 32
    python -m repro_torch.launch.serve --arch recurrentgemma-2b --batch 4 \
        --prompt-len 2560 --gen 32
    python -m repro_torch.launch.serve --preset seamless-m4t-large-v2 \
        --device cpu
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \
        --batch 4 --prompt-len 1024 --gen 32

``--preset`` takes lm100m, lmtiny or a ported architecture's smoke
configuration; ``--arch`` a ported architecture's published one (the
dense qwen3-8b, yi-6b, phi3-mini-3.8b, granite-34b; the MoE
deepseek-v2-lite-16b and grok-1-314b; rwkv6-3b, recurrentgemma-2b; the
encoder-decoder seamless-m4t-large-v2 and the vision model
llava-next-34b).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.launch.train import _preset
from repro_torch.models.layers import compute_dtype
from repro_torch.models.lm import (
    decode_step, init_cache, init_lm, prefill_step,
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_tokens(cfg: ModelConfig, batch: int, prompt_len: int,
                  seed: int) -> np.ndarray:
    """The reference's prompt: ``default_rng(seed)`` integers below the
    vocabulary size."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, prompt_len))


def prompt_frames(cfg: ModelConfig, batch: int, prompt_len: int,
                  seed: int) -> np.ndarray:
    """The encoder-decoder's prompt, as the reference's: ``(batch,
    prompt_len, d_model)`` normal draws of ``default_rng(seed)``, fp32."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, prompt_len, cfg.d_model)) \
        .astype(np.float32)


def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device="cuda", impl: str = "kernel",
          rec_impl: str = "kernel", moe_impl: str = "auto",
          params: Optional[Dict] = None, keep_logits: bool = False) -> Dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (the
    encoder-decoder: frames), then decode ``gen`` tokens each by argmax.
    ``params`` (a tree on ``device``) replaces the seeded init, which
    draws on ``device``.
    With ``keep_logits`` the result also holds the prefill logits, the
    first decode step's logits and every generated token (tensors)."""
    dev = resolve_device(device)
    if params is None:
        params = init_lm(cfg, seed, dev, draw_on=dev)
    max_len = prompt_len + gen + 1
    encdec = cfg.is_encoder_decoder
    cache = init_cache(cfg, batch, max_len,
                       enc_len=prompt_len if encdec else 0,
                       dtype=compute_dtype(cfg), device=dev)
    if encdec:
        prompt = {"frames": torch.from_numpy(prompt_frames(
            cfg, batch, prompt_len, seed)).to(dev)}
    else:
        prompt = {"tokens": torch.from_numpy(prompt_tokens(
            cfg, batch, prompt_len, seed)).to(dev)}
    start = 1 if encdec else prompt_len
    kw = dict(impl=impl, rec_impl=rec_impl, moe_impl=moe_impl)

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        with torch.profiler.record_function("serve/prefill"):
            logits, cache = prefill_step(params, cache, prompt, cfg, **kw)
            _sync(dev)
        t_prefill = time.perf_counter() - t0
        first = logits
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out_tokens = [tok]
        first_decode = None
        t0 = time.perf_counter()
        with torch.profiler.record_function("serve/decode"):
            for i in range(gen):
                logits, cache = decode_step(params, cache, tok,
                                            start + i, cfg, **kw)
                if i == 0:
                    first_decode = logits
                tok = torch.argmax(logits[:, -1:], dim=-1)
                out_tokens.append(tok)
            _sync(dev)
        t_decode = time.perf_counter() - t0
    toks = torch.cat(out_tokens, dim=1)
    out = {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * gen / max(t_decode, 1e-9),
        "generated": toks[:, :8].cpu().tolist(),
        "device": str(dev),
    }
    if keep_logits:
        out.update(prefill_logits=first, decode_logits=first_decode,
                   tokens=toks)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--preset", default="lmtiny",
                       help="lm100m, lmtiny, or a ported architecture's "
                            "smoke configuration")
    which.add_argument("--arch", default=None,
                       help="a ported architecture's published "
                            "configuration (e.g. qwen3-8b, rwkv6-3b)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch) if args.arch else _preset(args.preset)
    out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, seed=args.seed, device=args.device)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
