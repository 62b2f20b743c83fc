"""Paper §V-E / Fig. 14: sensitivity of (alpha, beta) (the reference's
``benchmarks/alpha_beta_sensitivity.py``).

Sweeps the paper's three configurations and reports pushes-to-PS frequency
and convergence accuracy; more-negative alpha -> fewer pushes, accuracy
roughly preserved (paper: max change -0.45%).

    python -m repro_torch.studies.alpha_beta_sensitivity [--fast]
        [--device cpu]
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.config import HermesConfig
from repro_torch.core.allocator import Allocation
from repro_torch.core.bundles import make_paper_bundle
from repro_torch.core.simulator import run_framework

CONFIGS = [(-0.9, 0.1), (-1.3, 0.1), (-1.6, 0.15)]


def run(*, fast: bool = False, device="cuda") -> List[Dict]:
    bundle, _ = make_paper_bundle("mnist", n=2500 if fast else 6000,
                                  eval_batch=128)
    rows = []
    for alpha, beta in CONFIGS:
        r = run_framework(
            "hermes", bundle, num_workers=6 if fast else 12,
            hermes_cfg=HermesConfig(alpha=alpha, beta=beta, lam=5,
                                    eta=bundle.eta),
            target_acc=0.88, max_iterations=400 if fast else 2500,
            max_wall=60 if fast else 300,
            init_alloc=Allocation(128, 16), eval_every=3, seed=0,
            device=device)
        pushes = r.calls_by_kind.get("push", 0)
        rows.append({
            "alpha": alpha, "beta": beta,
            "pushes": pushes,
            "iterations": r.iterations,
            "push_rate": round(pushes / max(r.iterations, 1), 4),
            "conv_acc": round(r.conv_acc, 4),
            "sim_time_s": round(r.sim_time, 2),
        })
    return rows


def main(argv=None) -> None:
    import argparse
    import json
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(fast=args.fast, device=args.device):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
