#!/usr/bin/env python3
"""Card time of the flash-attention kernels at the serving path's shapes
(``chip_smoke.py`` phases 6 and 14a), for the ``repro_torch`` package under
``--src``.  On an NVIDIA card:

    python tools/flash_probe.py [--src src] [--only fp32]

Run it against two checkouts in one call (a parent commit unpacked into a
git-ignored directory with ``git archive <rev> src``, then this one, in
turns: parent, change, change, parent) to compare their kernels on one
card.  The cases: the fp32 prefills of ``flash_simt`` at lm100m (B 8, 12
heads of 64 on 4, Sq 512 into a 577-slot cache), deepseek-v2-lite's MLA
(B 4, 16 heads at D 192 / Dv 128, Sq 1024 into 1057 slots) and
recurrentgemma-2b (B 4, 10 heads of 256 on one, 2560 tokens, window
2048); lm100m decode at 512 (``flash_decode`` + combine),
recurrentgemma-2b's bf16 prefill (``flash_prefill``) and decode on the
wrapped 2048-slot ring, and the split kernel of that decode alone
(``--only fp32`` keeps the first three).  Prints one JSON line: the card's
name and power limit, then each case's kernel, its card time per call
(CUDA events around a call queued behind a spin of the card, as
``chip_smoke.py:device_ms``; mean of 20), its largest distance from the
plain version, its bound (the larger of its operations, ``2 (D + Dv)``
FLOPs a visible pair, over the peak of its dtype, and its bytes over 3.35
TB/s), the share of the bound the kernel reaches, and SDPA's time with the
positions' boolean mask (one PyTorch call for the same function, timed
only).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM data sheet
HBM_BYTES_PER_S = 3.35e12


def device_ms(torch, fn, reps: int = 20) -> float:
    """Mean card time per call of ``fn()``, each call queued behind a spin
    of the card three times as long as the host takes to issue it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    torch.cuda.synchronize()
    spin = int(1_000_000 / start.elapsed_time(end) * max(2.0, 3 * issue_ms))
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--only", choices=("all", "fp32"), default="all")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_probe: needs an NVIDIA card")
    from repro_torch.kernels.flash_attention import (
        decode_split, design, flash_attention_cuda, flash_attention_plain,
        visible)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    i32 = dict(dtype=torch.int32, device=dev)

    def linear(skv, written):
        kvpos = torch.arange(skv, **i32)
        kvpos[written:] = -1
        return kvpos

    ring = torch.cat([torch.arange(2048, 2560, **i32),
                      torch.arange(512, 2048, **i32)])
    f32, bf16 = torch.float32, torch.bfloat16
    # (label, B, Sq, H, K, D, Dv, first query position, KV positions,
    #  window, dtype)
    cases = [("lm100m prefill", 8, 512, 12, 4, 64, 64, 0, linear(577, 512),
              0, f32),
             ("mla prefill fp32", 4, 1024, 16, 16, 192, 128, 0,
              linear(1057, 1024), 0, f32),
             ("rg prefill fp32", 4, 2560, 10, 1, 256, 256, 0,
              torch.arange(2560, **i32), 2048, f32)]
    if args.only == "all":
        cases += [("lm100m decode@512", 8, 1, 12, 4, 64, 64, 512,
                   linear(577, 513), 0, f32),
                  ("rg prefill bf16", 4, 2560, 10, 1, 256, 256, 0,
                   torch.arange(2560, **i32), 2048, bf16),
                  ("rg decode@2560 bf16", 4, 1, 10, 1, 256, 256, 2560, ring,
                   2048, bf16)]
    out = {"src": args.src, "device": torch.cuda.get_device_name(0),
           "card": card_line()}
    for label, B, Sq, H, K, D, Dv, q0, kvpos, window, dt in cases:
        Skv = kvpos.numel()
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
        k = torch.randn((B, Skv, K, D), generator=gen, device=dev).to(dt)
        v = torch.randn((B, Skv, K, Dv), generator=gen, device=dev).to(dt)
        qpos = torch.arange(q0, q0 + Sq, **i32)
        kw = dict(causal=True, window=window)
        got = flash_attention_cuda(q, k, v, qpos, kvpos, **kw)
        want = flash_attention_plain(q, k, v, qpos, kvpos, **kw)
        mask = visible(qpos, kvpos, causal=True, window=window)
        pairs = int(mask.sum())
        flops = 2 * B * H * pairs * (D + Dv)
        moved = (q.numel() + k.numel() + v.numel() + got.numel()) \
            * q.element_size() + 4 * (Sq + Skv)
        bound_ms = 1e3 * max(flops / PEAK_OPS[str(dt)[6:]],
                             moved / HBM_BYTES_PER_S)
        ms = device_ms(torch, lambda: flash_attention_cuda(
            q, k, v, qpos, kvpos, **kw))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out[label] = {
            "kernel": design(Sq, D, dt, Dv), "ms": ms,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
            "sdpa_ms": device_ms(torch, lambda: sdpa(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))}
        if label.startswith("rg decode"):
            out["rg decode split alone"] = {"ms": device_ms(
                torch, lambda: decode_split(q, k, v, qpos, kvpos,
                                            scale=D ** -0.5, **kw))}
        del q, k, v, got, want, mask, qt, kt, vt
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
