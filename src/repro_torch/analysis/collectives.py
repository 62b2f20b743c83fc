"""Collective-placement rule: what may cross the pod axis, and at what size
(the reference's ``analysis/collectives.py``).

Hermes's communication claim holds only if the one model-sized thing to
cross the pod axis is the registered wire payloads
(``dist.wire.wire_operand_specs``), each exactly once.  The reference
reads the collectives from a round's lowered HLO.  Eager PyTorch has no
HLO, so the port counts them where they are issued: :func:`count_collectives`
wraps ``torch.distributed``'s ``all_gather_into_tensor``, ``all_gather``,
``broadcast``, ``all_reduce``, ``reduce_scatter_tensor`` and
``all_to_all_single`` in a rank's process and logs each call's group,
kind and operand; :func:`records` names each call's tier against the
rank's ``launch.mesh.PodGroups`` and turns the log into the records the
rule reads (``Target.collectives``).

Named violation classes:

* ``fp32-model-crossing``: a float32 / float64 operand larger than the
  control allowance crosses the pod axis matching no wire spec (the
  reference's GSPMD regression: the gather hoisted onto the fp32 delta,
  2-8x the billed bytes);
* ``unexpected-cross-pod-operand``: any other unmatched operand above the
  allowance (a payload that crosses twice, a re-gathered decode);
* ``missing-wire-operand``: a billed wire array never crossed;
* ``billing-drift``: the matched payload bytes differ from the bill;
* ``unexpected-cross-pod-collective``: with ``expect_none=True`` (closed
  rounds, commit halves, pod-local train steps), any pod-crossing
  collective besides the operands ``allow`` names.  The reference's
  closed round crosses nothing, because its ``lax.cond`` folds away; the
  port's exchanges the gates first (8 B a rank,
  ``wire.control_operand_spec``), and its closed-round check allows
  exactly that.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch.distributed as dist

from repro_torch.analysis.core import Rule, Target, Violation, register_rule

# scalar control traffic per collective operand: one 4-byte slot per pod
# plus an 8-byte slack.  Change it here and every gate moves together.
CONTROL_SLACK_BYTES = 8
CONTROL_BYTES_PER_POD = 4

#: the collectives :func:`count_collectives` logs, and the position and
#: keyword of the argument that crosses (the input of a gather or a
#: reduction)
COUNTED = {"all_gather_into_tensor": (1, "input_tensor"),
           "all_gather": (1, "tensor"), "broadcast": (0, "tensor"),
           "all_reduce": (0, "tensor"), "reduce_scatter_tensor": (1, "input"),
           "all_to_all_single": (1, "input")}


def control_traffic_allowance(n_pods: int) -> int:
    """Most bytes of one cross-pod operand still billed as control, not
    payload: ``4 * n_pods + 8``."""
    return CONTROL_BYTES_PER_POD * int(n_pods) + CONTROL_SLACK_BYTES


# -- counting ------------------------------------------------------------------

def _operand(t) -> Dict[str, Any]:
    return {"dtype": str(t.dtype).removeprefix("torch."),
            "dims": [int(d) for d in t.shape],
            "bytes": int(t.numel() * t.element_size())}


def count_collectives(log: List) -> Callable[[], None]:
    """Log every counted collective this process issues, as ``(group,
    kind, operand)`` (``group`` None: the default group; the port passes
    it by keyword), and return a function that puts the real ones back.
    Each call is logged before it is issued."""
    real = {name: getattr(dist, name) for name in COUNTED}

    def wrap(name):
        fn, (at, key) = real[name], COUNTED[name]

        def counted(*args, **kw):
            t = args[at] if len(args) > at else kw[key]
            log.append((kw.get("group"), name, _operand(t)))
            return fn(*args, **kw)
        return counted

    for name in COUNTED:
        setattr(dist, name, wrap(name))

    def restore():
        for name, fn in real.items():
            setattr(dist, name, fn)
    return restore


def tier(group, groups) -> str:
    """The tier of ``groups`` (a ``PodGroups``) that ``group`` is: ``pod``,
    ``intra`` or ``cluster``; ``other`` for none of them."""
    if groups is not None and group is groups.pod:
        return "pod"
    if groups is not None and groups.n_clusters > 1:
        if group is groups.intra:
            return "intra"
        if group is groups.cross:
            return "cluster"
    return "pod" if group is None else "other"


def _group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def records(entries: Sequence, groups) -> List[Dict[str, Any]]:
    """Logged calls as the rule's records: ``kind``, ``name`` (its index
    in the log), ``tier``, ``group_size`` and its one operand."""
    return [{"kind": kind, "name": f"{kind}#{i}", "tier": tier(g, groups),
             "group_size": _group_size(g), "operands": [op]}
            for i, (g, kind, op) in enumerate(entries)]


def cross_pod(recs: Sequence[Dict], tiers=("pod", "intra", "cluster")
              ) -> List[Dict]:
    """The records that cross pods: a tier in ``tiers`` over more than
    one rank (a group of one crosses nothing)."""
    return [r for r in recs if r["tier"] in tiers and r["group_size"] > 1]


# -- the rule ------------------------------------------------------------------

def _key(spec) -> tuple:
    dtype, dims, nbytes = spec
    return (str(dtype), tuple(int(d) for d in dims), int(nbytes))


def classify_collectives(records: List[Dict], specs, *,
                         control_bytes: Optional[int] = None,
                         n_pods: int = 2) -> Dict[str, Any]:
    """Match a round's pod-crossing collective operands against the
    expected wire specs (``(dtype, per-rank dims, bytes)``).  Every
    operand is either one expected payload array, each spec matching
    **exactly once**, so a payload that crosses twice or a model-sized
    fp32 that crosses at all is ``unexpected``, or control traffic of at
    most ``control_bytes`` (default :func:`control_traffic_allowance`).
    Returns ``{"payload_bytes", "control_bytes", "unmatched_specs",
    "unexpected"}``."""
    if control_bytes is None:
        control_bytes = control_traffic_allowance(n_pods)
    remaining = [_key(s) for s in specs]
    payload_b, control_b = 0, 0
    unexpected = []
    for r in records:
        for o in r.get("operands") or []:
            key = _key((o["dtype"], o["dims"], o["bytes"]))
            if key in remaining:
                remaining.remove(key)
                payload_b += key[2]
            elif key[2] <= control_bytes:
                control_b += key[2]
            else:
                unexpected.append({"kind": r["kind"], "name": r["name"],
                                   "operand": o})
    return {"payload_bytes": int(payload_b),
            "control_bytes": int(control_b),
            "unmatched_specs": remaining,
            "unexpected": unexpected}


@register_rule
class CollectivePlacement(Rule):
    """Every pod-crossing collective operand of ``target.collectives`` is
    a registered wire spec or control traffic; with ``billed_bytes`` the
    payload total must equal the bill.

    ``expect_none=True`` requires the target to cross the pod axis with
    nothing but the operands in ``allow`` (each at most once).  Two-tier
    mode (``n_clusters``): ``specs`` licenses the pod and intra-cluster
    tiers and ``cluster_specs`` (``cluster_wire_operand_specs``) the slow
    cluster-crossing tier.  After ``check``, ``classification`` (and
    ``cluster_classification``) hold the classification, and ``records``
    the pod-crossing records."""

    name = "collective-placement"

    def __init__(self, specs: Sequence = (), *, n_pods: int,
                 billed_bytes: Optional[int] = None,
                 expect_none: bool = False, allow: Sequence = (),
                 control_bytes: Optional[int] = None,
                 n_clusters: Optional[int] = None,
                 cluster_specs: Sequence = (),
                 cluster_billed_bytes: Optional[int] = None):
        self.specs = list(specs)
        self.n_pods = int(n_pods)
        self.billed_bytes = billed_bytes
        self.expect_none = expect_none
        self.allow = [_key(s) for s in allow]
        self.control_bytes = (control_traffic_allowance(n_pods)
                              if control_bytes is None else int(control_bytes))
        self.n_clusters = None if n_clusters is None else int(n_clusters)
        self.cluster_specs = list(cluster_specs)
        self.cluster_billed_bytes = cluster_billed_bytes
        self.classification: Optional[Dict[str, Any]] = None
        self.cluster_classification: Optional[Dict[str, Any]] = None
        self.records: List[Dict] = []
        self.cluster_records: List[Dict] = []

    def _classify_tier(self, recs: List[Dict], specs: List,
                       billed: Optional[int], tier_name: str,
                       out: List[Violation]) -> Dict[str, Any]:
        cls = classify_collectives(recs, specs,
                                   control_bytes=self.control_bytes,
                                   n_pods=self.n_pods)
        for u in cls["unexpected"]:
            o = u["operand"]
            vcls = ("fp32-model-crossing"
                    if o["dtype"] in ("float32", "float64")
                    else "unexpected-cross-pod-operand")
            out.append(self.violation(
                vcls,
                f"{u['kind']} {u['name']!r} ships {o['dtype']}"
                f"{list(o['dims'])} ({o['bytes']} B) across the {tier_name} "
                f"axis, matching no registered wire spec (allowance "
                f"{self.control_bytes} B)", tier=tier_name, **u))
        for s in cls["unmatched_specs"]:
            out.append(self.violation(
                "missing-wire-operand",
                f"billed wire array {s[0]}{list(s[1])} ({s[2]} B) never "
                f"crossed the {tier_name} axis", tier=tier_name,
                spec=[s[0], list(s[1]), s[2]]))
        if (billed is not None and not out
                and cls["payload_bytes"] != int(billed)):
            out.append(self.violation(
                "billing-drift",
                f"the {tier_name} gather ships {cls['payload_bytes']} B a "
                f"rank but the registry bills {int(billed)} B",
                tier=tier_name, shipped=cls["payload_bytes"],
                billed=int(billed)))
        return cls

    def check(self, target: Target) -> List[Violation]:
        recs = cross_pod(target.collectives)
        self.records = recs
        out: List[Violation] = []
        if self.expect_none:
            allowed = list(self.allow)
            self.classification = {"payload_bytes": 0, "control_bytes": 0,
                                   "unmatched_specs": [], "unexpected": []}
            self.cluster_classification = dict(self.classification)
            for r in recs:
                keys = [_key((o["dtype"], o["dims"], o["bytes"]))
                        for o in r["operands"]]
                if all(k in allowed for k in keys):
                    for k in keys:
                        allowed.remove(k)
                        self.classification["control_bytes"] += k[2]
                    continue
                out.append(self.violation(
                    "unexpected-cross-pod-collective",
                    f"{r['kind']} {r['name']!r} crosses the {r['tier']} axis "
                    f"in a target that must stay pod-local "
                    f"({sum(o['bytes'] for o in r['operands'])} B)",
                    record=r))
            return out
        if self.n_clusters is not None:
            crecs = [r for r in recs if r["tier"] == "cluster"]
            self.cluster_records = crecs
            self.classification = self._classify_tier(
                [r for r in recs if r["tier"] != "cluster"], self.specs,
                self.billed_bytes, "pod", out)
            self.cluster_classification = self._classify_tier(
                crecs, self.cluster_specs, self.cluster_billed_bytes,
                "cluster", out)
            return out
        self.classification = self._classify_tier(
            recs, self.specs, self.billed_bytes, "pod", out)
        return out


def placement_rule(tree, mode: str, n_pods: int, *, rows: int = 1,
                   billed_bytes: Optional[int] = None
                   ) -> CollectivePlacement:
    """The rule of an open round or dispatch of ``tree`` placed one pod
    (``rows`` pods) a rank: the wire specs of ``dist.wire``, billed as
    ``payload_bytes`` (or ``billed_bytes``) times ``rows``."""
    from repro_torch.dist.compression import payload_bytes
    from repro_torch.dist.wire import wire_operand_specs
    billed = payload_bytes(tree, mode) if billed_bytes is None \
        else int(billed_bytes)
    return CollectivePlacement(
        wire_operand_specs(tree, mode, n_pods, rows=rows), n_pods=n_pods,
        billed_bytes=billed * rows)


def closed_rule(n_pods: int, *, rows: int = 1) -> CollectivePlacement:
    """The rule of a closed round: only the gate exchange crosses."""
    from repro_torch.dist.wire import control_operand_spec
    return CollectivePlacement(n_pods=n_pods, expect_none=True,
                               allow=[control_operand_spec(rows)])


def pod_local_rule(n_pods: int) -> CollectivePlacement:
    """The rule of a commit half or a pod-local step: nothing crosses."""
    return CollectivePlacement(n_pods=n_pods, expect_none=True)


__all__ = [
    "CONTROL_BYTES_PER_POD", "CONTROL_SLACK_BYTES", "COUNTED",
    "CollectivePlacement", "classify_collectives", "closed_rule",
    "control_traffic_allowance", "count_collectives", "cross_pod",
    "placement_rule", "pod_local_rule", "records", "tier",
]
