"""Paper §V-C / Fig. 12: straggler behavior — allocator trace + async rounds
(the reference's ``benchmarks/straggler.py``).

* ``run()`` — Hermes with dynamic dataset sizing, recording the allocator
  trace for the weakest worker family (B1ms), whose iteration times should
  stabilize toward the cluster median; plus a BSP control quantifying the
  straggler wait.

* ``async_overlap()`` — the same heterogeneous cluster (Table II families
  span a >=2x iteration-time spread) run with sync vs ``async_rounds``,
  comparing simulated wall-clock per synchronization round and the
  pipeline-bubble fraction (``RunResult.comm_stall / sim_time``).  Sync
  bills every push's transfer + PS service + pull serially against the
  pushing worker; async overlaps the round trip with the next iteration's
  compute and bills only the residue, so at the same iterations async
  must finish in less simulated time and with a smaller bubble share
  (``_assert_overlap``).  The section is written to ``--out``
  (``results/torch/async_overlap.json`` by default).

    python -m repro_torch.studies.straggler [--fast] [--async-only]
        [--out PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from repro_torch.config import HermesConfig
from repro_torch.core.allocator import Allocation
from repro_torch.core.bundles import make_paper_bundle
from repro_torch.core.simulator import run_framework
from repro_torch.dist.compression import payload_bytes
from repro_torch.utils.trees import tree_leaves


def run(*, fast: bool = False, device="cuda") -> Dict:
    bundle, _ = make_paper_bundle("mnist", n=2500 if fast else 6000,
                                  eval_batch=128)
    r = run_framework(
        "hermes", bundle, num_workers=6 if fast else 12,
        hermes_cfg=HermesConfig(alpha=-1.3, beta=0.1, lam=5, eta=bundle.eta),
        target_acc=0.99,  # run long enough for several allocator sweeps
        max_iterations=400 if fast else 1500,
        max_wall=60 if fast else 240,
        init_alloc=Allocation(128, 16), alloc_every=2.0, seed=0,
        device=device)

    times = {w: np.asarray(v) for w, v in r.worker_iter_times.items()}
    med = float(np.median(np.concatenate(list(times.values()))))
    weakest = [w for w in times if w.startswith("B1ms")]
    out: Dict = {"median_iter_time": round(med, 3),
                 "alloc_events": len(r.alloc_trace),
                 "alloc_trace_head": r.alloc_trace[:10]}
    for w in weakest:
        t = times[w]
        half = len(t) // 2
        out[f"{w}_mean_early"] = round(float(t[:max(half, 1)].mean()), 3)
        out[f"{w}_mean_late"] = round(float(t[half:].mean()), 3) if half \
            else None
        # stabilization: late-phase time should sit nearer the median
        if half:
            out[f"{w}_late_gap_to_median"] = round(
                abs(float(t[half:].mean()) - med), 3)
    # static-allocation control: BSP wait on the straggler
    b = run_framework("bsp", bundle, num_workers=6 if fast else 12,
                      target_acc=0.99, max_iterations=200 if fast else 600,
                      max_wall=40 if fast else 120,
                      init_alloc=Allocation(128, 16), seed=0, device=device)
    bt = {w: np.asarray(v) for w, v in b.worker_iter_times.items()}
    slowest = max(bt, key=lambda w: bt[w].mean())
    fastest = min(bt, key=lambda w: bt[w].mean())
    out["bsp_straggler_ratio"] = round(
        float(bt[slowest].mean() / bt[fastest].mean()), 2)
    return out


def _mode_stats(r, *, bytes_per_element: float) -> Dict:
    rounds = max(1, r.ps_updates)
    return {
        "sim_time": round(r.sim_time, 3),
        "iterations": r.iterations,
        "merges": r.ps_updates,
        "wall_clock_per_round": round(r.sim_time / rounds, 4),
        "comm_stall": round(r.comm_stall, 3),
        "bubble_fraction": round(r.comm_stall / max(r.sim_time, 1e-9), 4),
        "conv_acc": round(r.conv_acc, 4),
        "bytes_per_element": round(bytes_per_element, 4),
    }


def async_overlap(*, fast: bool = False, seed: int = 0,
                  device="cuda") -> Dict:
    """Sync vs async Hermes rounds on a >=2x-heterogeneous cluster."""
    bundle, _ = make_paper_bundle("mnist", n=2500 if fast else 6000,
                                  eval_batch=128)
    n_workers = 6 if fast else 12
    base = dict(alpha=-1.3, beta=0.1, lam=5, eta=bundle.eta)
    # fixed data allocation (alloc_every past any horizon): the allocator
    # would shrink the stragglers' shards toward the median and erode the
    # very heterogeneity this study measures; fixed iteration budget +
    # unreachable target so both modes run the same amount of work
    common = dict(num_workers=n_workers, target_acc=2.0,
                  max_iterations=500 if fast else 1500,
                  max_wall=90 if fast else 240,
                  init_alloc=Allocation(128, 16), alloc_every=1e9,
                  patience=10 ** 9, seed=seed, device=device)

    sync = run_framework("hermes", bundle,
                         hermes_cfg=HermesConfig(**base), **common)
    asyn = run_framework(
        "hermes", bundle,
        hermes_cfg=HermesConfig(async_rounds=True, **base), **common)

    # the cluster's pod-speed spread, measured from what actually ran
    means = {w: float(np.mean(v))
             for w, v in sync.worker_iter_times.items() if v}
    het = max(means.values()) / min(means.values())
    assert het >= 2.0, (
        f"cluster heterogeneity {het:.2f}x below the 2x profile this "
        f"study requires (Table II families)")

    cfg = HermesConfig(**base)
    params0 = bundle.init(torch.Generator().manual_seed(seed), device)
    n_elements = sum(x.numel() for x in tree_leaves(params0))
    bpe = payload_bytes(params0, cfg.compression) / n_elements

    s, a = (_mode_stats(sync, bytes_per_element=bpe),
            _mode_stats(asyn, bytes_per_element=bpe))
    out = {
        "workers": n_workers,
        "heterogeneity_ratio": round(het, 2),
        "compression": cfg.compression,
        "bytes_per_element": round(bpe, 4),
        "sync": s,
        "async": a,
        "round_speedup": round(
            s["wall_clock_per_round"] / a["wall_clock_per_round"], 3),
    }
    _assert_overlap(s, a)
    return out


def _assert_overlap(s: Dict, a: Dict) -> None:
    """Async overlap, read from the two modes' ``_mode_stats``.

    The reference asserts the per-round wall-clock (``sim_time / merges``)
    instead of the sim time.  That holds only on average: the two modes
    interleave the workers' events differently, so their gates fire on
    different losses and the merge counts differ from run to run by about
    as much as the overlap saves (~7% at the fast settings).  On the CPU
    it fails in the reference's own run at seed 1 and in the port's at
    seeds 1 and 3; on the card, whose convolutions accumulate in a
    varying order, it fails in some runs of seed 0.  The sim
    time at the same iterations carries no gate noise: every worker's
    iteration times are drawn from its own stream in both modes, and only
    sync delays them by the round trips it bills."""
    assert a["iterations"] == s["iterations"], (
        f"async ran {a['iterations']} iterations, sync {s['iterations']}: "
        f"the modes must do the same work to be compared")
    assert a["sim_time"] < s["sim_time"], (
        f"async sim time {a['sim_time']} s not below sync {s['sim_time']} s "
        f"for the same {a['iterations']} iterations")
    assert a["bubble_fraction"] < s["bubble_fraction"], (
        f"async bubble fraction {a['bubble_fraction']} not below "
        f"sync {s['bubble_fraction']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--async-only", action="store_true",
                    help="skip the allocator-trace section")
    ap.add_argument("--out", default="results/torch/async_overlap.json",
                    help="where the async_overlap section is written")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out: Dict = {}
    if not args.async_only:
        out["allocator_trace"] = run(fast=args.fast, device=args.device)
    out["async_overlap"] = async_overlap(fast=args.fast, device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out["async_overlap"], f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
