#!/usr/bin/env python3
"""How far the port's flash attention sits from an fp64 softmax at
recurrentgemma-2b's fp32 shapes, and how long it takes there, for the
``repro_torch`` package under ``--src``: prefill over 2560 tokens (B 4,
10 query heads of 256 on one KV head, window 2048) and decode at
position 2560 on the wrapped 2048-slot ring.  On an NVIDIA card:

    python tools/flash_fp64_gap.py [--src src]

Run it against two checkouts in one call (a parent commit unpacked into a
git-ignored directory, then this one) to compare their kernels on one
card.  Prints one JSON line: for each case the kernel's and the plain
version's largest absolute distance from fp64, and the kernel's mean time
over 10 calls (CUDA events).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_fp64_gap: needs an NVIDIA card")
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain, visible)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    i32 = dict(dtype=torch.int32, device=dev)
    ring = torch.cat([torch.arange(2048, 2560, **i32),
                      torch.arange(512, 2048, **i32)])
    out = {"src": args.src, "device": torch.cuda.get_device_name(0)}
    for label, Sq, q0, kvpos in (("rg prefill fp32", 2560, 0,
                                  torch.arange(2560, **i32)),
                                 ("rg decode@2560 fp32", 1, 2560, ring)):
        B, H, K, D, window = 4, 10, 1, 256, 2048
        Skv = kvpos.numel()
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev)
        k, v = (torch.randn((B, Skv, K, D), generator=gen, device=dev)
                for _ in range(2))
        qpos = torch.arange(q0, q0 + Sq, **i32)
        kw = dict(causal=True, window=window)
        got = flash_attention_cuda(q, k, v, qpos, kvpos, **kw)
        want = flash_attention_plain(q, k, v, qpos, kvpos, **kw)
        sc = torch.einsum("bqkgd,bskd->bkgqs",
                          q.double().reshape(B, Sq, K, H // K, D),
                          k.double()) * D ** -0.5
        sc = sc.masked_fill(~visible(qpos, kvpos, **kw), -torch.inf)
        exact = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(sc, -1),
                             v.double()).reshape(B, Sq, H, D)
        del sc
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        flash_attention_cuda(q, k, v, qpos, kvpos, **kw)
        start.record()
        for _ in range(10):
            flash_attention_cuda(q, k, v, qpos, kvpos, **kw)
        end.record()
        torch.cuda.synchronize()
        out[label] = {
            "kernel_from_fp64": float((got.double() - exact).abs().max()),
            "plain_from_fp64": float((want.double() - exact).abs().max()),
            "kernel_ms": start.elapsed_time(end) / 10}
        del q, k, v, got, want, exact
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
