"""Where the Hermes trainer's time goes on the card: ``torch.profiler`` over
a short lm100m run (4 pods, batch 8, seq 128, lam 2, int4), after a
warm-up run in the same process.

    python -m repro_torch.launch.trace_round [--steps 4] [--trace PATH]

Prints one JSON line: the profiled host time inside the trainer's
``hermes/pod_step`` and ``hermes/round`` ranges (the loop does not wait
for the card, so this is the host's time to issue the work), the loop's
window (from the first range's start to the last range's end on the host
or on the device), the device time of the kernels and copies that start
in it, the device's busy share of the window, and the kernels with the
most device time in it.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

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
    host_us = {r: sum(e.cpu_time_total for e in prof.key_averages()
                      if e.key == r) for r in RANGES}
    events = prof.events()
    spans = [e.time_range for e in events if e.name in RANGES]
    lo, hi = min(t.start for t in spans), max(t.end for t in spans)
    by_name: Dict[str, list] = {}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in RANGES and lo <= e.time_range.start < hi):
            calls_us = by_name.setdefault(e.name, [0, 0.0])
            calls_us[0] += 1
            calls_us[1] += e.time_range.elapsed_us()
    busy_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "steps": args.steps, "rounds": out["rounds"],
        "merges": out["merges"],
        "ms_per_step": out["ms_per_step"],
        "ms_per_round": out["ms_per_round"],
        "host_ms": {r: v / 1e3 for r, v in host_us.items()},
        "loop_ms": (hi - lo) / 1e3,
        "device_kernel_ms": busy_us / 1e3,
        "device_busy_share": busy_us / (hi - lo),
        "launches": sum(n for n, _ in by_name.values()),
        "top_kernels": [{"name": name[:90], "calls": n, "device_ms": us / 1e3}
                        for name, (n, us) in top[:25]],
    }))

if __name__ == "__main__":
    main()
