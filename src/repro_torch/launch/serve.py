"""Batched serving: prefill a prompt batch, then decode greedily (the
reference's ``launch/serve.py``).

On a card, prefill and decode run attention (GQA and MLA) through the
flash-attention kernels, the RWKV6 time-mix through the WKV6 kernel and
the RG-LRU through its kernel (``impl="kernel"``, ``rec_impl="kernel"``);
on the CPU the same calls take the kernels' plain versions.  The MoE
block takes ``moe_impl`` (auto: dense at 512 tokens or fewer, else
sorted).  Parameters are fp32, as in the reference's ``serve``
(``launch/steps.py`` holds them in bf16 instead).

    python -m repro_torch.launch.serve --preset lmtiny --device cpu
    python -m repro_torch.launch.serve --preset recurrentgemma-2b \
        --device cpu --prompt-len 40
    python -m repro_torch.launch.serve --preset lm100m --batch 8 \
        --prompt-len 512 --gen 64
    python -m repro_torch.launch.serve --arch rwkv6-3b --batch 4 \
        --prompt-len 256 --gen 32
    python -m repro_torch.launch.serve --arch recurrentgemma-2b --batch 4 \
        --prompt-len 2560 --gen 32

``--preset`` takes lm100m, lmtiny or a ported architecture's smoke
configuration; ``--arch`` a ported architecture's published one (the
dense qwen3-8b, yi-6b, phi3-mini-3.8b, granite-34b; the MoE
deepseek-v2-lite-16b and grok-1-314b; rwkv6-3b, recurrentgemma-2b).
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


def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device="cuda", impl: str = "kernel",
          rec_impl: str = "kernel", moe_impl: str = "auto",
          params: Optional[Dict] = None, keep_logits: bool = False) -> Dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen`` tokens each by argmax.  ``params`` (a tree on
    ``device``) replaces the seeded init, which draws on ``device``.
    With ``keep_logits`` the result also holds the prefill logits, the
    first decode step's logits and every generated token (tensors)."""
    dev = resolve_device(device)
    if params is None:
        params = init_lm(cfg, seed, dev, draw_on=dev)
    max_len = prompt_len + gen + 1
    cache = init_cache(cfg, batch, max_len, dtype=compute_dtype(cfg),
                       device=dev)
    prompt = torch.from_numpy(prompt_tokens(cfg, batch, prompt_len,
                                            seed)).to(dev)
    kw = dict(impl=impl, rec_impl=rec_impl, moe_impl=moe_impl)

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        with torch.profiler.record_function("serve/prefill"):
            logits, cache = prefill_step(params, cache, {"tokens": prompt},
                                         cfg, **kw)
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
                                            prompt_len + i, cfg, **kw)
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
