"""The Hermes round's wire audit at a real architecture's width (the
reference's ``launch/hermes_dryrun.py``).

The reference lowers one full Level-B round of qwen3-8b in bf16 on a
512-device ``(2, 16, 16)`` pod mesh and holds the lowered cross-pod
collectives to the wire bill.  The port audits the same claim in two
parts:

(a) **Full width and depth, on ``meta`` tensors** (nothing allocated):
    for every wire format, ``payload_bytes`` of the bf16 tree equals the
    bytes of ``dist.wire.wire_operand_specs`` for its fp32 twin (the
    registry bills fp32 leaves; ``none`` ships a leaf's own dtype, so the
    bf16 tree's ``none`` wire is half that bill, which
    :func:`shipped_bill` states), int4 bills at most 0.5625 B an element,
    the bills with the sharding hint (``param_axes`` and ``arch_rules`` on
    the ``(2, 16, 16)`` mesh shape, ``multi_pod=False``, batch 256) equal
    those without, and ``block_axis`` with the hint drifts on no leaf.
(b) **Executed, at full width**: the round placed on two gloo ranks, one
    pod a rank, in bf16, in every format (``launch.placed_audit``): the
    placed ``w_global``, pod rows and error rows hash as the unplaced
    run's on every rank, the collective-placement rule holds each rank's
    counted collectives to the bill of the tree that ran, and the closed
    round crosses only the gate exchange.  The depth is cut (``--layers``,
    at least 1 of qwen3-8b's 36): every distinct leaf shape but the layer
    count runs.  ``--smoke`` runs the smoke config instead.

``--drop-pod``, ``--rejoin-pod`` and ``--clusters N`` run
``placed_audit``'s elastic and two-tier cases on a stand-in, the
reference's round tree, as the reference executes its elastic proofs on
a small stand-in mesh.  The output is one JSON record.

    python -m repro_torch.launch.hermes_dryrun [--arch qwen3-8b] [--layers 1]
    python -m repro_torch.launch.hermes_dryrun --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.analysis import collectives as C
from repro_torch.configs import get_config
from repro_torch.dist import wire
from repro_torch.dist.compression import payload_bytes
from repro_torch.launch import placed_audit as pa
from repro_torch.launch.mesh import (
    arch_parallel_config, arch_rules, make_production_mesh,
)
from repro_torch.launch.round_audit import INT4_BOUND, N_PODS, flat_rule, hold
from repro_torch.launch.steps import abstract_init_lm
from repro_torch.utils.trees import tree_flatten, tree_map


def shipped_bill(tree, mode: str) -> int:
    """The bytes one push of ``tree`` puts on the wire as it runs:
    ``payload_bytes`` (which bills fp32 leaves), except that ``none``
    ships each leaf in its own dtype."""
    if mode == "none":
        return sum(x.numel() * x.element_size() for x in tree_flatten(tree)[0])
    return payload_bytes(tree, mode)


def _as(tree, dtype):
    return tree_map(lambda x: torch.empty(x.shape, dtype=dtype,
                                          device="meta"), tree)


def full_width_bills(arch: str = "qwen3-8b",
                     formats: Sequence[str] = wire.available_formats(),
                     dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Part (a): the bills of ``arch`` at full width and depth on ``meta``
    tensors, each held to the wire specs and to the sharding hint."""
    cfg = get_config(arch)
    params, axes = abstract_init_lm(cfg)
    tree, tree32 = _as(params, dtype), _as(params, torch.float32)
    leaves = tree_flatten(tree)[0]
    n_elts = sum(x.numel() for x in leaves)
    mesh = make_production_mesh(multi_pod=True)
    rules = arch_rules(cfg, mesh, arch_parallel_config(arch),
                       multi_pod=False, batch=256)
    out: Dict[str, Any] = {"arch": arch, "parameters": n_elts,
                           "dtype": str(dtype).removeprefix("torch."),
                           "mesh": {"axes": list(mesh.axis_names),
                                    "shape": list(mesh.shape)},
                           "formats": {}}
    for fmt in formats:
        billed = payload_bytes(tree, fmt)
        specs32 = sum(s[2] for s in wire.wire_operand_specs(tree32, fmt,
                                                            N_PODS))
        specs = sum(s[2] for s in wire.wire_operand_specs(tree, fmt, N_PODS))
        hinted = payload_bytes(tree, fmt, param_axes=axes, rules=rules)
        if not billed == specs32 == hinted:
            raise AssertionError(f"{arch}/{fmt}: bill {billed}, fp32 specs "
                                 f"{specs32}, hinted bill {hinted}")
        if specs != shipped_bill(tree, fmt):
            raise AssertionError(f"{arch}/{fmt}: the {dtype} wire ships "
                                 f"{specs} B, its bill is "
                                 f"{shipped_bill(tree, fmt)}")
        out["formats"][fmt] = {"billed_bytes": billed,
                               "wire_spec_bytes": specs,
                               "bytes_per_element": billed / n_elts}
    if "int4" in out["formats"] and \
            out["formats"]["int4"]["bytes_per_element"] > INT4_BOUND:
        raise AssertionError(f"int4 bills {out['formats']['int4']} > "
                             f"{INT4_BOUND} B an element")
    drift = [(tuple(x.shape), a)
             for x, a in zip(leaves, tree_flatten(axes)[0])
             if wire.block_axis(x.shape) != wire.block_axis(
                 x.shape, axes=a, rules=rules)]
    if drift:
        raise AssertionError(f"{len(drift)} leaves pick a sharded-but-"
                             f"misaligned blocked axis: {drift[:3]}")
    out["block_axis_hint_drift"] = 0
    return out


def executed(arch: str = "qwen3-8b", *, layers: int = 1, smoke: bool = False,
             formats: Sequence[str] = wire.available_formats(),
             dtype: str = "bfloat16", device="cuda",
             workdir: Optional[str] = None) -> Dict[str, Any]:
    """Part (b): the open and the closed round of ``arch`` (cut to
    ``layers``; ``smoke``: its smoke config) placed on ``N_PODS`` ranks
    against the unplaced run, every format, held to the rule."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    got = pa.audit(arch, ranks=N_PODS, n_pods=N_PODS, n_clusters=1,
                   formats=formats, cases=("flat", "closed"), device=dev,
                   layers=0 if smoke else layers, dtype=dtype,
                   workdir=workdir)
    job = {"preset": arch, "seed": 0, "layers": 0 if smoke else layers,
           "dtype": dtype}
    tree = pa._w_global(job, pa.META)
    n_elts = sum(x.numel() for x in tree_flatten(tree)[0])
    out: Dict[str, Any] = {
        "arch": arch, "config": "smoke" if smoke else "published",
        "layers": pa._config(job).num_layers,
        "cut": None if smoke else (
            f"depth {layers} of {get_config(arch).num_layers} layers; "
            f"every other leaf shape at full width"),
        "dtype": dtype, "parameters": n_elts, "device": str(dev),
        "formats": {}, "seconds": time.perf_counter() - t0,
        "unplaced_seconds": got["unplaced_s"], "rank_launches": {}}
    for c in got["cases"].values():
        for per_rank in c["launches"]:
            for k, v in per_rank.items():
                out["rank_launches"][k] = out["rank_launches"].get(k, 0) + v
    for fmt in formats:
        entry: Dict[str, Any] = {}
        for case in ("flat", "closed"):
            c = got["cases"][f"{fmt}/{case}"]
            if not c["equal"]:
                raise AssertionError(f"{arch}/{fmt}/{case}: a placed rank "
                                     f"differs from the unplaced round")
            # the open round is held to the bill of the tree that ran
            entry[case] = {"bit_identical": True,
                           "merged": c["unplaced_merged"],
                           "collectives": hold(c, fmt, lambda ph: flat_rule(
                               c, ph, lambda: C.placement_rule(
                                   tree, fmt, N_PODS,
                                   billed_bytes=shipped_bill(tree, fmt))))}
        shipped = entry["flat"]["collectives"]["flat_round"]["gather_bytes"]
        entry["shipped_bill"] = shipped_bill(tree, fmt)
        entry["payload_bytes"] = payload_bytes(tree, fmt)
        entry["bytes_per_element"] = shipped / n_elts
        # a published width's leaves are whole blocks but for a few tails;
        # the smoke config's narrow leaves pad, so the bound is not its
        if fmt == "int4" and not smoke and shipped / n_elts > INT4_BOUND:
            raise AssertionError(f"int4 ships {shipped / n_elts} B an "
                                 f"element > {INT4_BOUND}")
        out["formats"][fmt] = entry
    if dev.type == "cuda":
        ranks = got["peak_bytes"]
        parent = torch.cuda.max_memory_allocated(dev)
        out["peak_bytes"] = {"unplaced": parent, "ranks": ranks,
                             "phase": max(parent, sum(ranks))}
    return out


def stand_in(*, drop_pod: bool = False, rejoin_pod: bool = False,
             clusters: int = 1, device="cuda",
             workdir: Optional[str] = None) -> Dict[str, Any]:
    """The elastic and two-tier cases on the reference's round tree:
    ``drop`` / ``rejoin`` on four ranks (``none`` and ``int8``), and the
    two-tier round at ``2 * clusters`` pods in ``clusters`` clusters on as
    many ranks, held to the rule tier by tier."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    elastic = [c for c, on in (("drop", drop_pod), ("rejoin", rejoin_pod))
               if on]
    if elastic:
        got = pa.audit("round", ranks=4, n_pods=4, n_clusters=2,
                       formats=("none", "int8"), cases=(), elastic=elastic,
                       device=dev, workdir=workdir)
        for key, case in got["elastic"].items():
            if not (case["equal"] and case["collectives"] == case["expected"]):
                raise AssertionError(f"{key}: placed rows or collectives "
                                     f"differ")
            out[key] = {"bit_identical": True, "rows": case["rows"],
                        "members": case["members"]}
    if clusters > 1:
        n = 2 * clusters
        tree = {k: torch.empty(s, device="meta")
                for k, s in pa.ROUND.items()}
        got = pa.audit("round", ranks=n, n_pods=n, n_clusters=clusters,
                       formats=wire.available_formats(),
                       cases=("cluster", "cluster_async", "closed"),
                       device=dev, workdir=workdir)

        def rule_for(case, phase, fmt):
            # both tiers billed one payload row a rank
            if phase == "commit":
                return C.pod_local_rule(n)
            if not case["unplaced_merged"][
                    -1 if phase == "cluster_round" else 0]:
                return C.closed_rule(n)
            bill = payload_bytes(tree, fmt)
            return C.CollectivePlacement(
                wire.wire_operand_specs(tree, fmt, n, n_clusters=clusters),
                n_pods=n, billed_bytes=bill, n_clusters=clusters,
                cluster_specs=wire.cluster_wire_operand_specs(
                    tree, fmt, clusters, n_pods=n),
                cluster_billed_bytes=bill)

        out["clusters"] = {"n_pods": n, "n_clusters": clusters,
                           "formats": {}}
        for key, case in got["cases"].items():
            if not case["equal"]:
                raise AssertionError(f"{key}: a placed rank differs")
            fmt = key.split("/")[0]
            out["clusters"]["formats"][key] = hold(
                case, key, lambda ph: rule_for(case, ph, fmt))
    return out


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--layers", type=int, default=1,
                    help="the executed round's depth (the bills of part (a) "
                         "are at full depth)")
    ap.add_argument("--smoke", action="store_true",
                    help="execute the smoke config instead")
    ap.add_argument("--formats", nargs="+",
                    default=list(wire.available_formats()))
    ap.add_argument("--drop-pod", action="store_true")
    ap.add_argument("--rejoin-pod", action="store_true")
    ap.add_argument("--clusters", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON record")
    args = ap.parse_args(argv)
    rec = {"bills": full_width_bills(args.arch, args.formats),
           "executed": executed(args.arch, layers=args.layers,
                                smoke=args.smoke, formats=args.formats,
                                device=args.device)}
    if args.drop_pod or args.rejoin_pod or args.clusters > 1:
        rec["stand_in"] = stand_in(drop_pod=args.drop_pod,
                                   rejoin_pod=args.rejoin_pod,
                                   clusters=args.clusters,
                                   device=args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
