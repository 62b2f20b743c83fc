"""Quickstart: Hermes vs BSP on a 6-worker heterogeneous edge cluster
(the reference's ``examples/quickstart.py``).

Runs the paper's algorithm (HermesGUP gate + loss-based SGD + dynamic
allocation) against Bulk Synchronous Parallel on a synthetic-MNIST CNN and
prints the Table-III-style comparison.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch.config import HermesConfig
from repro_torch.core.allocator import Allocation
from repro_torch.core.bundles import make_paper_bundle
from repro_torch.core.simulator import run_framework


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bundle, _ = make_paper_bundle("mnist", n=3000, eval_batch=128)
    kw = dict(num_workers=6, target_acc=0.90, max_iterations=500,
              max_wall=60, init_alloc=Allocation(128, 16), eval_every=3,
              device=args.device)

    print("running Hermes ...")
    h = run_framework("hermes", bundle,
                      hermes_cfg=HermesConfig(alpha=-1.3, beta=0.1, lam=5,
                                              eta=bundle.eta), **kw)
    print("running BSP ...")
    b = run_framework("bsp", bundle, **kw)

    print(f"\n{'':10s}{'iters':>8s}{'sim time':>10s}{'acc':>8s}"
          f"{'API calls':>11s}{'WI':>6s}")
    for r in (b, h):
        print(f"{r.framework:10s}{r.iterations:8d}{r.sim_time:9.1f}s"
              f"{r.conv_acc:8.3f}{r.api_calls:11d}{r.wi_avg:6.2f}")
    print(f"\nHermes speedup vs BSP: {b.sim_time / h.sim_time:.2f}x; "
          f"comm reduction: {1 - h.api_calls / b.api_calls:.1%}")


if __name__ == "__main__":
    main()
