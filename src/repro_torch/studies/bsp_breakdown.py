"""Paper Fig. 2/4/5: BSP time breakdown per node family (the reference's
``benchmarks/bsp_breakdown.py``).

Per family: mean iteration (train) time, wait time until the barrier, and
the share of the superstep wasted waiting — the motivation plots for
dynamic allocation.

    python -m repro_torch.studies.bsp_breakdown [--fast] [--device cpu]
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.allocator import Allocation
from repro_torch.core.bundles import make_paper_bundle
from repro_torch.core.simulator import run_framework


def run(*, fast: bool = False, device="cuda") -> Dict:
    bundle, _ = make_paper_bundle("mnist", n=2500 if fast else 5000,
                                  eval_batch=128)
    r = run_framework("bsp", bundle, num_workers=6 if fast else 12,
                      target_acc=0.99, max_iterations=150 if fast else 400,
                      max_wall=45 if fast else 120,
                      init_alloc=Allocation(128, 16), seed=0, device=device)
    fams: Dict[str, list] = {}
    for w, ts in r.worker_iter_times.items():
        fam = w.rsplit("_", 1)[0]
        fams.setdefault(fam, []).extend(ts)
    rows = {}
    all_means = {f: float(np.mean(v)) for f, v in fams.items()}
    barrier = max(all_means.values())
    for f, v in fams.items():
        m = float(np.mean(v))
        rows[f] = {
            "mean_train_s": round(m, 3),
            "mean_wait_s": round(barrier - m, 3),
            "wait_fraction": round((barrier - m) / barrier, 3),
        }
    return {"families": rows, "barrier_s": round(barrier, 3),
            "straggler_family": max(all_means, key=all_means.get)}


def main(argv=None) -> None:
    import argparse
    import json
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(fast=args.fast, device=args.device), indent=2))


if __name__ == "__main__":
    main()
