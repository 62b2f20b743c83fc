"""The paper's full 12-worker cluster (the reference's
``examples/train_hermes_cluster.py``).

Trains the ~110K-param CNN on synthetic-MNIST with all five baselines plus
Hermes, on the heterogeneous Table-II cluster, and writes a JSON report
with the Table III columns, the allocator events and the pushes.

    python -m repro_torch.examples.train_hermes_cluster [--fast]
        [--out PATH] [--device cpu]
"""
import argparse
import json
import os

from repro_torch.config import HermesConfig
from repro_torch.core.allocator import Allocation
from repro_torch.core.bundles import make_paper_bundle
from repro_torch.core.simulator import run_framework


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--out", default="results/torch/hermes_cluster.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    bundle, _ = make_paper_bundle("mnist", n=2500 if args.fast else 6000,
                                  eval_batch=128)
    kw = dict(num_workers=6 if args.fast else 12, target_acc=0.88,
              max_iterations=400 if args.fast else 3000,
              max_wall=60 if args.fast else 360,
              init_alloc=Allocation(128, 16), eval_every=3,
              device=args.device)

    report = {}
    base_time = None
    for fw in ("bsp", "asp", "ssp", "ebsp", "selsync", "hermes"):
        print(f"== {fw} ==", flush=True)
        r = run_framework(fw, bundle,
                          hermes_cfg=HermesConfig(alpha=-1.3, beta=0.1,
                                                  lam=5, eta=bundle.eta),
                          **kw)
        if fw == "bsp":
            base_time = r.sim_time
        report[fw] = {
            "iterations": r.iterations,
            "sim_time_s": round(r.sim_time, 2),
            "conv_acc": round(r.conv_acc, 4),
            "reached": r.reached_target,
            "wi_avg": round(r.wi_avg, 2),
            "api_calls": r.api_calls,
            "speedup_vs_bsp": round(base_time / max(r.sim_time, 1e-9), 2),
            "alloc_events": len(r.alloc_trace),
            "pushes": r.calls_by_kind.get("push", 0),
        }
        print(json.dumps(report[fw]), flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
