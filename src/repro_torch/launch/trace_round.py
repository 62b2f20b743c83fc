"""Where the Hermes trainer's time goes on the card: ``torch.profiler`` over
a short lm100m run (4 pods, batch 8, seq 128, lam 2, int4), after a
warm-up run in the same process.

    python -m repro_torch.launch.trace_round [--steps 4] [--trace PATH]

Prints one JSON line: the profiled host time inside the trainer's
``hermes/pod_step`` and ``hermes/round`` ranges (each ends in a device
synchronise), the device time of every kernel summed, the device's busy
share of those ranges, and the kernels with the most device time.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.config import HermesConfig, OptimizerConfig
from repro_torch.launch.train import _preset, train_hermes

RANGES = ("hermes/pod_step", "hermes/round")


def device_us(evt, ranges=RANGES) -> float:
    """Device time of a kernel or copy entry; 0 for host-side ops, whose
    attributed device time would count each kernel twice, and for the
    named ``ranges``, which the trace mirrors on the device."""
    if evt.device_type != torch.autograd.DeviceType.CUDA or evt.key in ranges:
        return 0.0
    return float(evt.self_device_time_total)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the profiled run here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_round: needs an NVIDIA card")
    run = dict(batch=8, seq=128, pods=4, log_every=10 ** 6, device="cuda",
               opt_cfg=OptimizerConfig(name="adamw", lr=3e-4),
               hcfg=HermesConfig(alpha=-1.3, beta=0.1, lam=2, eta=1.0))
    cfg = _preset("lm100m")
    train_hermes(cfg, steps=2, **run)  # warm-up: cuBLAS, allocator, kernels
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = train_hermes(cfg, steps=args.steps, **run)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    avgs = prof.key_averages()
    host_us = {r: sum(e.cpu_time_total for e in avgs if e.key == r)
               for r in RANGES}
    kernels = sorted((e for e in avgs if device_us(e) > 0),
                     key=device_us, reverse=True)
    device_us = sum(device_us(e) for e in kernels)
    span_us = sum(host_us.values())
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "steps": args.steps, "rounds": out["rounds"],
        "merges": out["merges"],
        "host_ms": {r: v / 1e3 for r, v in host_us.items()},
        "device_kernel_ms": device_us / 1e3,
        "device_busy_share": device_us / span_us if span_us else None,
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "device_ms": device_us(e) / 1e3}
                        for e in kernels[:25]],
    }))


if __name__ == "__main__":
    main()
