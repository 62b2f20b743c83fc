#!/usr/bin/env python3
"""The WKV6 and RG-LRU scans of the ``repro_torch`` package under
``--src``, on an NVIDIA card:

    python tools/scan_probe.py [--src src] [--reps 10] [--serve]

Each scan runs at its serving shapes (WKV6: rwkv6-3b, B 4, 40 heads of
64, bf16; the RG-LRU: recurrentgemma-2b, B 4, W 2560, fp32) over a sweep
of T (1, 16, 256, 2560).  Each case is held to the plain version (WKV6:
max abs error of y and of the state; the RG-LRU: bitwise), then timed as
``chip_smoke.py`` times it: the card's own time per call (``device_ms``)
and the wall time of back-to-back calls (CUDA events), beside the
bound (each input read once and each output written once at 3.35 TB/s,
or the operations at the peak rate of the fastest input type) and the
card time's share of it.  With ``--serve`` it also serves rwkv6-3b
(batch 4, prompt 256, 32 new tokens) and recurrentgemma-2b (batch 4,
prompt 2560, 32 new tokens) on the kernel path after a warm-up serve,
and reports prefill seconds, decode tokens per second and the scan
launches.  Run it against two checkouts in one call (a parent commit
unpacked into a git-ignored directory, then this one, in turns) to
compare their kernels on one card.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SWEEP = (1, 16, 256, 2560)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--serve", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    from chip_smoke import bound, device_ms, time_ms
    if not torch.cuda.is_available():
        raise SystemExit("scan_probe: needs an NVIDIA card")
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru_scan import rglru_cuda, rglru_plain
    from repro_torch.kernels.rwkv6_scan import wkv6_cuda, wkv6_plain

    dev = torch.device("cuda", 0)
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"src": args.src, "device": smi, "wkv6": {}, "rglru": {}}
    gen = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def timed(fn, moved, flops, dtypes):
        card = device_ms(torch, fn, args.reps)
        bound_ms, by = bound(flops, moved, dtypes)
        return {"card_ms": card, "wall_ms": time_ms(torch, fn, 20),
                "bound_ms": bound_ms, "bound_by": by,
                "of_bound": bound_ms / card}

    B, H, D, W = 4, 40, 64, 2560
    for T in SWEEP:
        r, k, v = (randn(B, T, H, D).bfloat16() for _ in range(3))
        log_w = -torch.exp(0.3 * randn(B, T, H, D))
        u, s0 = 0.5 * randn(H, D), randn(B, H, D, D)
        y, s1 = wkv6_cuda(r, k, v, log_w, u, s0)
        y_ref, s1_ref = wkv6_plain(r, k, v, log_w, u, s0)
        case = {"y_err": float((y.float() - y_ref.float()).abs().max()),
                "y_max": float(y_ref.float().abs().max()),
                "state_err": float((s1 - s1_ref).abs().max()),
                "state_max": float(s1_ref.abs().max())}
        del y, s1, y_ref, s1_ref
        moved = 3 * r.numel() * 2 + log_w.numel() * 4 + u.numel() * 4 \
            + r.numel() * 2 + 2 * s0.numel() * 4
        case.update(timed(lambda: wkv6_cuda(r, k, v, log_w, u, s0), moved,
                          7 * D * D * B * H * T, (r.dtype, log_w.dtype)))
        out["wkv6"][f"T{T}"] = case
        del r, k, v, log_w, u, s0
        torch.cuda.empty_cache()

        a = torch.exp(-0.1 * torch.rand((B, T, W), generator=gen,
                                        device=dev))
        b, h0 = 0.3 * randn(B, T, W), randn(B, W)
        y, hT = rglru_cuda(a, b, h0)
        y_ref, hT_ref = rglru_plain(a, b, h0)
        case = {"equal": bool(torch.equal(y, y_ref)
                              and torch.equal(hT, hT_ref))}
        del y, hT, y_ref, hT_ref
        moved = (3 * a.numel() + 2 * h0.numel()) * 4
        case.update(timed(lambda: rglru_cuda(a, b, h0), moved, 2 * B * T * W,
                          (a.dtype,)))
        out["rglru"][f"T{T}"] = case
        del a, b, h0
        torch.cuda.empty_cache()

    if args.serve:
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import serve
        from repro_torch.models.lm import init_lm
        out["serve"] = {}
        for arch, prompt in (("rwkv6-3b", 256), ("recurrentgemma-2b", 2560)):
            cfg = get_config(arch)
            params = init_lm(cfg, 0, dev, draw_on=dev)
            serve(cfg, batch=4, prompt_len=prompt, gen=2, device=dev,
                  params=params)
            build.reset_launches()
            res = serve(cfg, batch=4, prompt_len=prompt, gen=32, device=dev,
                        params=params)
            out["serve"][arch] = {
                "prefill_s": res["prefill_s"],
                "decode_tok_per_s": res["decode_tok_per_s"],
                "launches": {k: n for k, n in build.LAUNCHES.items()
                             if k in ("wkv6", "rglru") and n}}
            del params
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
