"""Paper §V-B: communication reduction (62.1% fewer API calls than SSP).

Compares Hermes vs SSP API calls and bytes at a matched accuracy target, and
breaks calls down by kind (push/pull/data/telemetry); the reference's
``benchmarks/comm_overhead.py``.

``format_study`` runs the same Hermes workload once per registered wire
format (fp16 / int8 / int4 with stochastic rounding, all with error
feedback), the pushes really quantized by ``dist.compression.compress_tree``
before the PS merges them.

``--smoke`` is the billing gate: it asserts the ordering int4 < int8 <
fp16 < none on a real parameter tree and the int4 bill of nibbles plus
scales, and runs a tiny int4 Hermes study end to end.

    python -m repro_torch.studies.comm_overhead [--smoke | --formats]
        [--fast] [--device cpu]
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.config import HermesConfig
from repro_torch.core.allocator import Allocation
from repro_torch.core.bundles import make_paper_bundle
from repro_torch.core.simulator import run_framework
from repro_torch.dist.compression import payload_bytes


def run(*, fast: bool = False, device="cuda") -> Dict:
    bundle, _ = make_paper_bundle("mnist", n=2500 if fast else 6000,
                                  eval_batch=128)
    kw = dict(num_workers=6 if fast else 12, target_acc=0.85,
              max_iterations=400 if fast else 2500,
              max_wall=60 if fast else 300,
              init_alloc=Allocation(128, 16), eval_every=3, seed=0,
              device=device)
    h = run_framework("hermes", bundle,
                      hermes_cfg=HermesConfig(alpha=-1.3, beta=0.1, lam=5,
                                              eta=bundle.eta), **kw)
    s = run_framework("ssp", bundle, **kw)
    reduction = 1.0 - h.api_calls / max(s.api_calls, 1)
    byte_reduction = 1.0 - h.bytes_transferred / max(s.bytes_transferred, 1)
    return {
        "hermes_api_calls": h.api_calls,
        "ssp_api_calls": s.api_calls,
        "api_call_reduction": round(reduction, 3),
        "hermes_mbytes": round(h.bytes_transferred / 1e6, 1),
        "ssp_mbytes": round(s.bytes_transferred / 1e6, 1),
        "byte_reduction": round(byte_reduction, 3),
        "hermes_calls_by_kind": h.calls_by_kind,
        "ssp_calls_by_kind": s.calls_by_kind,
        "paper_claim_api_reduction": 0.621,
    }


def format_study(*, fast: bool = False,
                 formats: Sequence[str] = ("none", "fp16", "int8", "int4"),
                 device="cuda") -> Dict:
    """Hermes convergence + wire bytes per registered wire format."""
    bundle, _ = make_paper_bundle("mnist", n=2500 if fast else 6000,
                                  eval_batch=128)
    kw = dict(num_workers=6 if fast else 12, target_acc=0.85,
              max_iterations=400 if fast else 2500,
              max_wall=60 if fast else 300,
              init_alloc=Allocation(128, 16), eval_every=3, seed=0,
              device=device)
    out: Dict[str, Dict] = {}
    for mode in formats:
        r = run_framework(
            "hermes", bundle,
            hermes_cfg=HermesConfig(alpha=-1.3, beta=0.1, lam=5,
                                    eta=bundle.eta, compression=mode), **kw)
        out[mode] = {
            "reached_target": r.reached_target,
            "conv_acc": round(r.conv_acc, 4),
            "sim_time_s": round(r.sim_time, 1),
            "push_mbytes": round(r.bytes_by_kind.get("push", 0.0) / 1e6, 2),
            "total_mbytes": round(r.bytes_transferred / 1e6, 2),
            "api_calls": r.api_calls,
            "ps_updates": r.ps_updates,
        }
    return out


def smoke(device="cuda") -> Dict:
    """Billing-regression gate.

    1. int4 < int8 < fp16 < none wire bytes on a real parameter tree,
       from ``payload_bytes``, the per-leaf bill the simulator charges a
       push (the measured bytes of the encoded payload).
    2. int4 bills 0.5 B/element + one fp32 scale per 256-block on a
       block-aligned LM-sized leaf: nibbles + scales exactly.
    3. A tiny int4 Hermes run end to end (stochastic rounding + error
       feedback through the simulator's compressed push path).
    """
    bundle, _ = make_paper_bundle("mnist", n=512, eval_batch=64)
    params = bundle.init(torch.Generator().manual_seed(0), device)
    bytes_by_mode = {m: payload_bytes(params, m)
                     for m in ("none", "fp16", "int8", "int4")}
    assert (bytes_by_mode["int4"] < bytes_by_mode["int8"]
            < bytes_by_mode["fp16"] < bytes_by_mode["none"]), bytes_by_mode
    n = 4096 * 2048
    lm_leaf = {"w": torch.zeros((4096, 2048), dtype=torch.float32,
                                device="meta")}
    int4_bytes = payload_bytes(lm_leaf, "int4")
    assert int4_bytes == n // 2 + 4 * (n // 256), int4_bytes  # nibbles+scales
    assert int4_bytes <= 0.5625 * n, int4_bytes
    assert 2 * int4_bytes <= payload_bytes(lm_leaf, "int8") + 4 * (n // 256)
    r = run_framework(
        "hermes", bundle, num_workers=4, target_acc=0.99,
        max_iterations=60, max_wall=30, eval_every=2, seed=0,
        init_alloc=Allocation(64, 16),
        hermes_cfg=HermesConfig(alpha=-0.5, beta=0.1, lam=3,
                                eta=bundle.eta, compression="int4"),
        device=device)
    assert r.iterations > 0 and r.bytes_transferred > 0
    return {
        "payload_bytes": bytes_by_mode,
        "int4_lm_leaf_bytes_per_elt": round(int4_bytes / n, 6),
        "int4_run": {"iterations": r.iterations,
                     "pushes": r.calls_by_kind.get("push", 0),
                     "mbytes": round(r.bytes_transferred / 1e6, 3)},
        "ok": True,
    }


def main(argv=None) -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="billing-regression gate (fast)")
    ap.add_argument("--formats", action="store_true",
                    help="per-wire-format convergence study")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        print(json.dumps(smoke(device=args.device), indent=2))
    elif args.formats:
        print(json.dumps(format_study(fast=args.fast, device=args.device),
                         indent=2))
    else:
        print(json.dumps(run(fast=args.fast, device=args.device), indent=2))


if __name__ == "__main__":
    main()
