"""Study runner — one function per paper table/figure (the reference's
``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV rows (us_per_call = simulated or
wall microseconds of the unit being measured; derived = the paper-facing
metric).  ``--fast`` shrinks every run; ``--only <name>`` selects a single
suite; ``--device cpu`` runs on the CPU (default: the card).

Suites:
    table3   — Table III convergence comparison (both datasets)
    comm     — §V-B API-call/byte reduction vs SSP
    straggler— §V-C / Fig. 12 dynamic allocation
    gup      — §V-D / Fig. 13 major-update trace
    alphabeta— §V-E / Fig. 14 sensitivity
    bsp      — Fig. 2/4/5 BSP breakdown
    kernels  — kernel microbenchmarks: not ported (ROADMAP queue 1 item 8;
               ``chip_smoke.py`` times the port's kernels); its row says so

    python -m repro_torch.studies.run [--fast] [--only NAME] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time


def _row(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def bench_table3(fast: bool, device) -> None:
    from repro_torch.studies import table3_convergence as T
    datasets = ["mnist"] if fast else ["mnist", "cifar"]
    for ds in datasets:
        rows = T.run(ds, fast=fast, device=device)
        for r in rows:
            us = r["sim_time_s"] * 1e6 / max(r["iterations"], 1)
            _row(f"table3/{ds}/{r['framework']}", us,
                 f"acc={r['conv_acc']};simT={r['sim_time_s']}s;"
                 f"iters={r['iterations']};WI={r['wi_avg']};"
                 f"api={r['api_calls']};speedup={r['speedup_vs_bsp']}x")


def bench_comm(fast: bool, device) -> None:
    from repro_torch.studies import comm_overhead as C
    r = C.run(fast=fast, device=device)
    _row("comm/hermes_vs_ssp", 0.0,
         f"api_reduction={r['api_call_reduction']};"
         f"byte_reduction={r['byte_reduction']};"
         f"paper_claim={r['paper_claim_api_reduction']}")


def bench_straggler(fast: bool, device) -> None:
    from repro_torch.studies import straggler as S
    r = S.run(fast=fast, device=device)
    _row("straggler/dynamic_alloc", 0.0,
         f"alloc_events={r['alloc_events']};"
         f"median={r['median_iter_time']}s;"
         f"bsp_straggler_ratio={r['bsp_straggler_ratio']}")


def bench_gup(fast: bool, device) -> None:
    from repro_torch.studies import gup_trace as G
    r = G.run(fast=fast, device=device)
    _row("gup/push_trace", 0.0,
         f"pushes={r['pushes']}/{r['iterations']};"
         f"push_loss={r['mean_loss_at_push']};mean_loss={r['mean_loss']};"
         f"improvements={r.get('pushes_are_improvements')}")


def bench_alphabeta(fast: bool, device) -> None:
    from repro_torch.studies import alpha_beta_sensitivity as A
    for r in A.run(fast=fast, device=device):
        _row(f"alphabeta/a{r['alpha']}_b{r['beta']}", 0.0,
             f"push_rate={r['push_rate']};acc={r['conv_acc']};"
             f"simT={r['sim_time_s']}s")


def bench_bsp(fast: bool, device) -> None:
    from repro_torch.studies import bsp_breakdown as B
    r = B.run(fast=fast, device=device)
    for fam, row in r["families"].items():
        _row(f"bsp_breakdown/{fam}", row["mean_train_s"] * 1e6,
             f"wait={row['mean_wait_s']}s;"
             f"wait_frac={row['wait_fraction']}")


def bench_kernels(fast: bool, device) -> None:
    raise NotImplementedError(
        "the kernel microbenchmarks (benchmarks/kernel_bench.py: roofline "
        "and HLO) wait for ROADMAP queue 1 item 8; chip_smoke.py times the "
        "port's kernels")


SUITES = {
    "table3": bench_table3,
    "comm": bench_comm,
    "straggler": bench_straggler,
    "gup": bench_gup,
    "alphabeta": bench_alphabeta,
    "bsp": bench_bsp,
    "kernels": bench_kernels,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = [args.only] if args.only else list(SUITES)
    print("name,us_per_call,derived")
    for n in names:
        t0 = time.time()
        try:
            SUITES[n](args.fast, args.device)
        except Exception as e:  # keep the suite running
            _row(f"{n}/ERROR", 0.0, f"{type(e).__name__}:{e}")
        print(f"# {n} done in {time.time()-t0:.1f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
