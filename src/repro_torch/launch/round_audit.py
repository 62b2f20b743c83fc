"""Round audit: the payload-gather merge, proven on executed rounds (the
reference's ``launch/round_audit.py``).

On ``N_PODS`` gloo ranks, one pod a rank, per wire format:

1. **Equivalence** (``launch.placed_audit``'s cases on the reference's
   round tree, one blocked leaf and one short tail): ``hermes_round``,
   ``hermes_dispatch`` + ``hermes_commit`` and a closed round placed over
   the pod group, each bitwise the unplaced round on every rank.
2. **The collective pin** (the reference's ``lowering_pin`` and
   ``async_pin``, on the collectives each rank counted in place of the
   lowered HLO): the open round and the dispatch each gather every wire
   operand of ``dist.wire.wire_operand_specs`` once, nothing fp32
   model-sized crosses, the gathered bytes equal ``payload_bytes``' bill,
   int4 ships at most 0.5625 B an element, the closed round crosses only
   the gate exchange and the commit nothing.  The collective-placement
   rule (``analysis.collectives``) raises on any of these.
3. **Resize** (``placed_audit``'s elastic ``drop`` and ``rejoin`` cases
   on four ranks): each rank's rows bitwise the never-resized oracle,
   each step's collectives its spec.
4. **Async parity** (:func:`async_parity`): one deterministic loss
   schedule through synchronous and pipelined rounds, unplaced:
   ``dispatched == committed == sync opens``, and the final global
   models within 0.05 (the pipelined refreshes land a round late).

    python -m repro_torch.launch.round_audit [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.analysis import analyze
from repro_torch.analysis import collectives as C
from repro_torch.config import HermesConfig
from repro_torch.dist import wire
from repro_torch.dist.compression import payload_bytes
from repro_torch.launch import placed_audit as pa

N_PODS = 2
RESIZE_PODS = 4     # the elastic cases: a shrink 4 -> 3 keeps real gathers
INT4_BOUND = 0.5625  # B an element: nibbles + fp32 block scales


def _tree():
    """The round tree as ``meta`` tensors: what the specs read."""
    return {k: torch.empty(s, device="meta") for k, s in pa.ROUND.items()}


def flat_rule(case: Dict[str, Any], phase: str, open_rule):
    """The rule of one phase of a flat placed case: a commit crosses
    nothing, a round or dispatch that did not merge only the gate
    exchange, an open one ``open_rule()``."""
    if phase == "commit":
        return C.pod_local_rule(N_PODS)
    if not case["unplaced_merged"][-1 if phase == "cluster_round" else 0]:
        return C.closed_rule(N_PODS)
    return open_rule()


def hold(case: Dict[str, Any], label: str, rule_for) -> Dict[str, Any]:
    """Hold every phase of a placed case, rank by rank, to
    ``rule_for(phase)`` (raises ``AnalysisError``); returns each phase's
    gathered bytes, control bytes and pod-crossing collectives, which
    every rank must share."""
    out: Dict[str, Any] = {}
    for phase in case["records"][0]:
        got = []
        for r, recs in enumerate(case["records"]):
            rule = rule_for(phase)
            analyze([rule], collectives=recs[phase],
                    label=f"{label}/{phase}@rank{r}")
            got.append({"gather_bytes": rule.classification["payload_bytes"],
                        "control_bytes": rule.classification["control_bytes"],
                        "cross_pod_collectives": len(rule.records)})
        if any(g != got[0] for g in got):
            raise AssertionError(f"{label}/{phase}: the ranks shipped {got}")
        out[phase] = got[0]
    return out


def audit_rounds(formats: Sequence[str] = wire.available_formats(), *,
                 device="cuda", resize: bool = True,
                 resize_formats: Sequence[str] = ("none", "int8"),
                 workdir: Optional[str] = None) -> Dict[str, Any]:
    """Equivalence and the collective pin for every format, then the
    resize cycles; raises on any difference or violation."""
    dev = resolve_device(device)
    tree = _tree()
    placed = pa.audit("round", ranks=N_PODS, n_pods=N_PODS, n_clusters=1,
                      formats=formats, cases=("flat", "flat_async",
                                              "closed"),
                      device=dev, workdir=workdir)
    rec: Dict[str, Any] = {"n_pods": N_PODS, "device": str(dev),
                           "formats": {}}
    for fmt in formats:
        entry: Dict[str, Any] = {}
        for case in ("flat", "flat_async", "closed"):
            got = placed["cases"][f"{fmt}/{case}"]
            if not got["equal"]:
                raise AssertionError(f"{fmt}/{case}: a placed rank differs "
                                     f"from the unplaced round")
            entry[case] = {"bit_identical": True,
                           "merged": got["unplaced_merged"],
                           "collectives": hold(got, fmt, lambda ph: flat_rule(
                               got, ph, lambda: C.placement_rule(
                                   tree, fmt, N_PODS)))}
        rec["formats"][fmt] = entry
        entry["billed_bytes"] = payload_bytes(tree, fmt)
        for case, phase in (("flat", "flat_round"), ("flat_async",
                                                     "dispatch")):
            per_elt = entry[case]["collectives"][phase]["gather_bytes"] / \
                sum(x.numel() for x in tree.values())
            entry[case]["bytes_per_element"] = per_elt
            if fmt == "int4" and per_elt > INT4_BOUND:
                raise AssertionError(f"int4 {case} ships {per_elt} B an "
                                     f"element > {INT4_BOUND}")
    if resize:
        el = pa.audit("round", ranks=RESIZE_PODS, n_pods=RESIZE_PODS,
                      n_clusters=2, formats=resize_formats, cases=(),
                      elastic=("drop", "rejoin"), device=dev,
                      workdir=workdir)
        rec["resize"] = {}
        for key, case in el["elastic"].items():
            ok = case["equal"] and case["collectives"] == case["expected"]
            if not ok:
                raise AssertionError(f"resize {key}: placed rows or "
                                     f"collectives differ")
            rec["resize"][key] = {"bit_identical": True,
                                  "rows": case["rows"],
                                  "collectives_match_specs": True}
    return rec


def async_parity(mode: str, n_rounds: int = 8, tol: float = 0.05,
                 device="cuda") -> Dict[str, Any]:
    """Staleness-1 parity and drain accounting, unplaced: the same
    deterministic loss schedule through ``hermes_round`` and the pipelined
    dispatch / commit loop (commit one round late, then a final drain).
    The gate trajectories are the same; the pipelined refreshes land a
    round later, so the final global models agree to ``tol``, not
    bitwise, while the accounting is exact: every dispatched open round
    commits once."""
    from repro_torch.dist import hermes_sync as hs
    from repro_torch.launch.analyze import _toy
    dev = resolve_device(device)
    cfg = HermesConfig(alpha=-0.3, beta=0.1, lam=2, window=4,
                       compression=mode)
    L = torch.tensor(1.0, device=dev)
    s_pods, s_wg = _toy(dev)
    a_pods, a_wg = s_pods, s_wg
    s_gup = a_gup = hs.hermes_pod_state(cfg, N_PODS, dev)
    s_err = a_err = pending = None
    dispatched = committed = 0
    sync_opens = []
    for r in range(n_rounds):
        losses = torch.tensor([1.0 - 0.08 * r, 1.2 if r < 3 else 0.3],
                              device=dev)
        noise = wire.GeneratorNoise(42, dev)
        out = hs.hermes_round(s_pods, s_gup, losses, s_wg, L, cfg,
                              error=s_err, round_step=r, noise=noise)
        s_pods, s_wg, s_gup, s_err = (out["pod_params"], out["w_global"],
                                      out["gup"], out["error"])
        sync_opens.append(bool(out["merged"]))
        if pending is not None:
            committed += int(hs.pending_merges(pending))
            cm = hs.hermes_commit(a_pods, pending, a_wg, cfg=cfg)
            a_pods, a_wg = cm["pod_params"], cm["w_global"]
        dp = hs.hermes_dispatch(a_pods, a_gup, losses, a_wg, L, cfg,
                                error=a_err, round_step=r, noise=noise)
        a_gup, a_err, pending = dp["gup"], dp["error"], dp["pending"]
        dispatched += int(hs.pending_merges(pending))
    committed += int(hs.pending_merges(pending))  # the drain
    cm = hs.hermes_commit(a_pods, pending, a_wg, cfg=cfg)
    a_wg = cm["w_global"]
    diff = max(float((s_wg[k] - a_wg[k]).abs().max()) for k in s_wg)
    if not dispatched == committed == sum(sync_opens):
        raise AssertionError(f"{mode}: dispatched {dispatched}, committed "
                             f"{committed}, sync opens {sync_opens}")
    if not diff <= tol:
        raise AssertionError(f"{mode}: final w_global differs by {diff} > "
                             f"{tol}")
    return {"rounds": n_rounds, "open_rounds": int(sum(sync_opens)),
            "dispatched": dispatched, "committed": committed,
            "drained": True, "final_wg_max_abs_diff": diff,
            "tolerance": tol, "within_tolerance": True}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--formats", nargs="+",
                    default=list(wire.available_formats()))
    ap.add_argument("--no-resize", action="store_true",
                    help="skip the elastic cases on four ranks")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON record")
    args = ap.parse_args(argv)
    rec = audit_rounds(args.formats, device=args.device,
                       resize=not args.no_resize)
    for fmt in args.formats:
        rec["formats"][fmt]["async_parity"] = async_parity(
            fmt, device=args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
