"""Where a Level-A study's time goes on the card: ``torch.profiler`` over
the quickstart's Hermes run (mnist n 3000, 6 workers, ``Allocation(128,
16)``, target 0.90, int4), after a warm-up run in the same process.

    python -m repro_torch.launch.trace_level_a [--framework hermes]
        [--trace PATH]

Prints one JSON line: the run's counters, its wall time (the
``level_a/run`` range on the host), the device time of the kernels and
copies that start in it, the device's busy share of it, and the kernels
with the most device time.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from repro_torch.config import HermesConfig
from repro_torch.core.allocator import Allocation
from repro_torch.core.bundles import make_paper_bundle
from repro_torch.core.simulator import run_framework

RANGE = "level_a/run"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--framework", default="hermes")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the profiled run here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_level_a: needs an NVIDIA card")
    bundle, _ = make_paper_bundle("mnist", n=3000, eval_batch=128)
    run = dict(num_workers=6, target_acc=0.90, max_iterations=500,
               max_wall=60, init_alloc=Allocation(128, 16), eval_every=3,
               hermes_cfg=HermesConfig(alpha=-1.3, beta=0.1, lam=5,
                                       eta=bundle.eta), device="cuda")
    # warm-up: cuDNN's algorithm choice, the allocator, the kernels
    run_framework(args.framework, bundle, **dict(run, max_iterations=12))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(RANGE):
            r = run_framework(args.framework, bundle, **run)
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)
    events = prof.events()
    span = next(e.time_range for e in events if e.name == RANGE
                and e.device_type != torch.autograd.DeviceType.CUDA)
    by_name: Dict[str, list] = {}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name != RANGE
                and span.start <= e.time_range.start < span.end):
            calls_us = by_name.setdefault(e.name, [0, 0.0])
            calls_us[0] += 1
            calls_us[1] += e.time_range.elapsed_us()
    busy_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "framework": r.framework, "iterations": r.iterations,
        "ps_updates": r.ps_updates, "sim_time": r.sim_time,
        "api_calls": r.api_calls, "conv_acc": r.conv_acc,
        "wall_s": wall_s, "window_ms": (span.end - span.start) / 1e3,
        "device_kernel_ms": busy_us / 1e3,
        "device_busy_share": busy_us / (span.end - span.start),
        "launches": sum(n for n, _ in by_name.values()),
        "top_kernels": [{"name": name[:90], "calls": n, "device_ms": us / 1e3}
                        for name, (n, us) in top[:15]],
    }))


if __name__ == "__main__":
    main()
