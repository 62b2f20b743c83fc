#!/usr/bin/env python3
"""How the sync-vs-async straggler study moves from run to run:

    PYTHONPATH=src python tools/async_overlap_probe.py [--runs 3]
        [--seeds 0 1 2] [--deterministic] [--device cpu]

Runs ``studies.straggler.async_overlap(fast=True)`` ``--runs`` times at
each seed and prints one JSON line a run: both modes' ``_mode_stats``,
``round_speedup``, whether async's per-round wall-clock came out below
sync's (the reference's assert) and whether the study's own asserts
held.  ``--deterministic`` runs under
``torch.use_deterministic_algorithms`` (warnings only), so the card's
convolutions accumulate in a fixed order and a seed gives one run.  The
first line is the card's name and power limit, or ``cpu``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.studies import straggler


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(), flush=True)
    else:
        print("cpu", flush=True)
    torch.use_deterministic_algorithms(args.deterministic, warn_only=True)
    for seed in args.seeds:
        for run in range(args.runs):
            t0 = time.perf_counter()
            try:
                out = straggler.async_overlap(fast=True, seed=seed,
                                              device=dev)
                rec = {"held": True, "round_speedup": out["round_speedup"],
                       "async_round_below_sync": (
                           out["async"]["wall_clock_per_round"]
                           < out["sync"]["wall_clock_per_round"]),
                       "sync": out["sync"], "async": out["async"]}
            except AssertionError as e:
                rec = {"held": False, "error": str(e)}
            print(json.dumps({"seed": seed, "run": run,
                              "deterministic": args.deterministic,
                              "wall_s": time.perf_counter() - t0, **rec}),
                  flush=True)


if __name__ == "__main__":
    main()
