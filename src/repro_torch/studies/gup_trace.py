"""Paper §V-D / Fig. 13: major-update markers on a worker's loss curve
(the reference's ``benchmarks/gup_trace.py``).

Extracts one worker's GUP trace (test loss per iteration, push flags) and
checks the semantic property of Fig. 13: pushes coincide with significant
drops relative to the recent window.

    python -m repro_torch.studies.gup_trace [--fast] [--device cpu]
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.config import HermesConfig
from repro_torch.core.allocator import Allocation
from repro_torch.core.bundles import make_paper_bundle
from repro_torch.core.simulator import run_framework


def run(*, fast: bool = False, device="cuda") -> Dict:
    bundle, _ = make_paper_bundle("mnist", n=2500 if fast else 6000,
                                  eval_batch=128)
    r = run_framework(
        "hermes", bundle, num_workers=6 if fast else 12,
        hermes_cfg=HermesConfig(alpha=-1.3, beta=0.1, lam=5, eta=bundle.eta),
        target_acc=0.88, max_iterations=400 if fast else 2000,
        max_wall=60 if fast else 240,
        init_alloc=Allocation(128, 16), seed=0, device=device)
    # pick the worker with the most pushes
    by_worker: Dict[str, list] = {}
    for t, w, loss, push in r.gup_trace:
        by_worker.setdefault(w, []).append((t, loss, push))
    best = max(by_worker, key=lambda w: sum(p for _, _, p in by_worker[w]))
    trace = by_worker[best]
    losses = np.array([l for _, l, _ in trace])
    pushes = np.array([p for _, _, p in trace], bool)
    # property: mean loss at push steps < mean loss overall
    out = {
        "worker": best,
        "iterations": len(trace),
        "pushes": int(pushes.sum()),
        "mean_loss": round(float(losses.mean()), 4),
        "mean_loss_at_push": round(float(losses[pushes].mean()), 4)
        if pushes.any() else None,
        "trace_head": [(round(t, 2), round(l, 4), bool(p))
                       for t, l, p in trace[:20]],
    }
    if pushes.any():
        out["pushes_are_improvements"] = bool(
            losses[pushes].mean() < losses.mean())
    return out


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
