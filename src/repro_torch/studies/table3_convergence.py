"""Paper Table III: Hermes vs BSP/ASP/SSP/EBSP (+SelSync) convergence.

Reports, per (dataset, framework): total local iterations, simulated time to
the accuracy target, WI_avg, convergence accuracy, API calls, and speedup
vs BSP, the columns of the paper's Table III, on the synthetic MNIST/CIFAR
stand-ins (the reference's ``benchmarks/table3_convergence.py``).

    python -m repro_torch.studies.table3_convergence [--fast] [--device cpu]
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.config import HermesConfig
from repro_torch.core.allocator import Allocation
from repro_torch.core.bundles import make_paper_bundle
from repro_torch.core.simulator import RunResult, run_framework


def run(dataset: str = "mnist", *, fast: bool = False,
        frameworks: List[str] = None, device="cuda") -> List[Dict]:
    frameworks = frameworks or ["bsp", "asp", "ssp", "ebsp", "selsync",
                                "hermes"]
    n = 2500 if fast else 6000
    bundle, noniid = make_paper_bundle(dataset, n=n, eval_batch=128)
    target = 0.88 if dataset == "mnist" else 0.62
    if fast:
        target -= 0.03
    kw = dict(num_workers=6 if fast else 12, noniid=noniid,
              target_acc=target, max_iterations=500 if fast else 4000,
              max_wall=60 if fast else 420,
              init_alloc=Allocation(128, 16), eval_every=3, seed=0,
              device=device)
    hermes_cfg = HermesConfig(alpha=-1.3, beta=0.1,
                              lam=5 if dataset == "mnist" else 15,
                              eta=bundle.eta)

    results: List[RunResult] = []
    for fw in frameworks:
        results.append(run_framework(fw, bundle, hermes_cfg=hermes_cfg, **kw))

    base = next((r for r in results if r.framework == "bsp"), results[0])
    rows = []
    for r in results:
        rows.append({
            "dataset": dataset,
            "framework": r.framework,
            "iterations": r.iterations,
            "sim_time_s": round(r.sim_time, 2),
            "wi_avg": round(r.wi_avg, 2),
            "conv_acc": round(r.conv_acc, 4),
            "reached": r.reached_target,
            "api_calls": r.api_calls,
            "mbytes": round(r.bytes_transferred / 1e6, 1),
            "speedup_vs_bsp": round(base.sim_time / max(r.sim_time, 1e-9), 2),
        })
    return rows


def main(argv=None) -> None:
    import argparse
    import json
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for ds in ("mnist", "cifar"):
        for row in run(ds, fast=args.fast, device=args.device):
            print(json.dumps(row))


if __name__ == "__main__":
    main()
