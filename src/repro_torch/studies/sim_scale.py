"""The fleet-scale sweep of the batch engine: participation rate x
clusters x wire format (the reference's ``benchmarks/sim_scale.py``).

Sweeps the batch/surrogate engine over participation rate, two-tier
cluster count and compression format at {100, 1k, 10k} workers, every
cell under the full churn trace (diurnal availability, battery dropout,
failure and recovery cycles).  Each cell records its wall seconds,
simulated seconds, PS pushes and billed bytes.  The batch engine runs on
numpy columns on the host: ``--device`` is resolved as for any
``run_framework`` call (the card unless ``cpu``), and no tensor is used.

    python -m repro_torch.studies.sim_scale [--fast] [--device cpu]
        [--out results/torch/sim_scale.json]

``--fast`` runs the {100, 1k} tiers with a short round budget and
asserts the invariants (admission monotone in prate, each cell under 60
s of wall, the slow tier at most the flat push bytes) without the 10k
tier.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

from repro_torch.config import HermesConfig
from repro_torch.core.engine import ChurnTrace, SurrogateBundle
from repro_torch.core.simulator import run_framework

CHURN = dict(diurnal_period_s=600.0, diurnal_duty=0.8,
             battery_s=400.0, recharge_s=120.0,
             failure_rate=1e-4, mean_downtime_s=60.0)


def _cell(n: int, rounds: int, prate: float, clusters: int,
          compression: str, *, seed: int = 7, device="cuda") -> Dict:
    hc = HermesConfig(participation_rate=prate, n_clusters=clusters,
                      compression=compression)
    t0 = time.time()
    r = run_framework(
        "hermes", SurrogateBundle(), num_workers=n, hermes_cfg=hc,
        seed=seed, target_acc=2.0, patience=10 ** 9,
        max_iterations=rounds * n, max_sim_time=1e9,
        churn=ChurnTrace(**CHURN), device=device)
    wall = time.time() - t0
    return {
        "workers": n, "rounds": rounds, "prate": prate,
        "clusters": clusters, "compression": compression,
        "wall_s": round(wall, 3),
        "sim_time_s": round(r.sim_time, 2),
        "iterations": r.iterations,
        "ps_updates": r.ps_updates,
        "push_gb": round(r.bytes_by_kind.get("push", 0.0) / 1e9, 3),
        "slow_tier_gb": round(
            r.bytes_by_kind.get("push_cluster", 0.0) / 1e9, 3),
        "total_gb": round(r.bytes_transferred / 1e9, 3),
        "meter_events": len(r.meter_events),
        "acc": round(r.conv_acc, 4),
    }


def run(*, fast: bool = False, device="cuda") -> Dict:
    tiers = [(100, 60), (1000, 40)] if fast else \
        [(100, 200), (1000, 200), (10_000, 200)]
    prates = [1.0, 0.5] if fast else [1.0, 0.75, 0.5, 0.25]
    clusters = [1, 4] if fast else [1, 4, 16]
    formats = ["none", "int8"] if fast else ["none", "fp16", "int8", "int4"]
    cells: List[Dict] = []
    for n, rounds in tiers:
        for prate in prates:
            cells.append(_cell(n, rounds, prate, 1, "none", device=device))
        for c in clusters[1:]:
            cells.append(_cell(n, rounds, 1.0, c, "none", device=device))
        for fmt in formats[1:]:
            cells.append(_cell(n, rounds, 1.0, 1, fmt, device=device))
        print(f"[sim_scale] n={n}: "
              f"{[c['wall_s'] for c in cells if c['workers'] == n]} s")

    # the invariants the sweep must show
    for n, _ in tiers:
        tier = [c for c in cells if c["workers"] == n]
        by_prate = sorted((c for c in tier if c["clusters"] == 1
                           and c["compression"] == "none"),
                          key=lambda c: -c["prate"])
        for hi, lo in zip(by_prate, by_prate[1:]):
            assert hi["ps_updates"] >= lo["ps_updates"], (hi, lo)
            assert hi["push_gb"] >= lo["push_gb"], (hi, lo)
        for c in tier:
            assert c["wall_s"] < 60.0, c
        flat = next(c for c in tier if c["clusters"] == 1
                    and c["prate"] == 1.0 and c["compression"] == "none")
        for c in tier:
            if c["clusters"] > 1:
                assert c["slow_tier_gb"] <= flat["push_gb"] + 1e-9, c
    return {"churn": CHURN, "cells": cells}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results/torch/sim_scale.json")
    args = ap.parse_args(argv)
    res = run(fast=args.fast, device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    slowest = max(c["wall_s"] for c in res["cells"])
    print(f"[sim_scale] {len(res['cells'])} cells, slowest {slowest:.2f}s "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
