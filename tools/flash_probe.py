#!/usr/bin/env python3
"""Card time of the flash-attention kernels at the serving path's shapes
(``chip_smoke.py`` phase 6's rows 8 / 8b), for the ``repro_torch``
package under ``--src``.  On an NVIDIA card:

    python tools/flash_probe.py [--src src]

Run it against two checkouts in one call (a parent commit unpacked into a
git-ignored directory with ``git archive <rev> src``, then this one, in
turns) to compare their kernels on one card.  The cases: lm100m prefill
(fp32, ``flash_simt``; B 8, 12 heads of 64 on 4, Sq 512 into a 577-slot
cache) and decode at 512 (``flash_decode`` + combine), recurrentgemma-2b
prefill (bf16, ``flash_prefill``; B 4, 10 heads of 256 on one, 2560
tokens, window 2048) and decode on the wrapped 2048-slot ring, and the
split kernel of that decode alone.  Prints one JSON line: each case's
kernel, its card time per call (CUDA events around a call queued behind a
spin of the card, as ``chip_smoke.py:device_ms``; mean of 20) and its
largest distance from the plain version.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_probe: needs an NVIDIA card")
    from repro_torch.kernels.flash_attention import (
        decode_split, design, flash_attention_cuda, flash_attention_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    i32 = dict(dtype=torch.int32, device=dev)
    lm_kv = torch.arange(577, **i32)
    ring = torch.cat([torch.arange(2048, 2560, **i32),
                      torch.arange(512, 2048, **i32)])
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("lm100m prefill", 8, 512, 12, 4, 64, 0,
              torch.where(lm_kv < 512, lm_kv, -1), 0, f32),
             ("lm100m decode@512", 8, 1, 12, 4, 64, 512,
              torch.where(lm_kv < 513, lm_kv, -1), 0, f32),
             ("rg prefill bf16", 4, 2560, 10, 1, 256, 0,
              torch.arange(2560, **i32), 2048, bf16),
             ("rg decode@2560 bf16", 4, 1, 10, 1, 256, 2560, ring, 2048,
              bf16)]
    out = {"src": args.src, "device": torch.cuda.get_device_name(0)}
    for label, B, Sq, H, K, D, q0, kvpos, window, dt in cases:
        Skv = kvpos.numel()
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((B, Skv, K, D), generator=gen, device=dev)
                .to(dt) for _ in range(2))
        qpos = torch.arange(q0, q0 + Sq, **i32)
        kw = dict(causal=True, window=window)
        got = flash_attention_cuda(q, k, v, qpos, kvpos, **kw)
        want = flash_attention_plain(q, k, v, qpos, kvpos, **kw)
        out[label] = {
            "kernel": design(Sq, D, dt),
            "ms": device_ms(torch, lambda: flash_attention_cuda(
                q, k, v, qpos, kvpos, **kw)),
            "max_abs_err": float((got.float() - want.float()).abs().max())}
        if label.startswith("rg decode"):
            out["rg decode split alone"] = {"ms": device_ms(
                torch, lambda: decode_split(q, k, v, qpos, kvpos,
                                            scale=D ** -0.5, **kw))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
