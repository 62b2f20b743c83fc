"""Where serving's time goes on the card: ``torch.profiler`` over one
``serve`` run (prefill, then greedy decode through the kernels), after a
warm-up run in the same process.

    python -m repro_torch.launch.trace_serve --preset lm100m \
        [--batch 8 --prompt-len 512 --gen 16] [--trace PATH]
    python -m repro_torch.launch.trace_serve --arch rwkv6-3b \
        --batch 4 --prompt-len 256 --gen 8
    python -m repro_torch.launch.trace_serve --arch recurrentgemma-2b \
        --batch 4 --prompt-len 2560 --gen 8

Prints one JSON line: the profiled host time inside ``serve``'s
``serve/prefill`` and ``serve/decode`` ranges (each ends in a device
synchronise), the device time of every kernel and copy summed, the
device's busy share of those ranges, the host-to-device copies, and the
kernels with the most device time.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.launch.trace_round import device_us
from repro_torch.launch.train import _preset
from repro_torch.models.lm import init_lm

RANGES = ("serve/prefill", "serve/decode")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--preset", default="lm100m")
    which.add_argument("--arch", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the profiled run here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_serve: needs an NVIDIA card")
    cfg = get_config(args.arch) if args.arch else _preset(args.preset)
    dev = torch.device("cuda")
    params = init_lm(cfg, 0, dev, draw_on=dev)
    run = dict(batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
               device=dev, params=params)
    serve(cfg, **run)  # warm-up: cuBLAS, allocator, kernels
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = serve(cfg, **run)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    avgs = prof.key_averages()
    host_us = {r: sum(e.cpu_time_total for e in avgs if e.key == r)
               for r in RANGES}
    kernels = sorted((e for e in avgs if device_us(e, RANGES) > 0),
                     key=lambda e: device_us(e, RANGES), reverse=True)
    dev_us = sum(device_us(e, RANGES) for e in kernels)
    span_us = sum(host_us.values())
    h2d = [e for e in avgs if "HtoD" in e.key]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "model": cfg.name,
        "batch": args.batch, "prompt_len": args.prompt_len,
        "gen": args.gen, "prefill_s": out["prefill_s"],
        "decode_tok_per_s": out["decode_tok_per_s"],
        "host_ms": {r: v / 1e3 for r, v in host_us.items()},
        "device_kernel_ms": dev_us / 1e3,
        "device_busy_share": dev_us / span_us if span_us else None,
        "kernel_launches": sum(e.count for e in kernels),
        "h2d_copies": sum(e.count for e in h2d),
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "device_ms": device_us(e, RANGES) / 1e3}
                        for e in kernels[:20]],
    }))


if __name__ == "__main__":
    main()
