"""Elastic membership of the Level-B Hermes state: lose a pod and re-admit
one in flight (the reference's ``launch/elastic.py``).

    python -m repro_torch.launch.elastic --device cpu
    python -m repro_torch.launch.elastic          # on the card

* **In-flight pod shrink** (``elastic_shrink`` + ``drop_pod_equivalence``):
  the state is *pod-stacked* (a leading ``(n_pods,)`` axis on pod_params,
  the gate state and the error-feedback residuals), so losing a pod is an
  index move, not a restart: keep the survivors' rows of every stacked
  tree (``shrink_pod_tree``) and re-split the data shards with
  ``core.allocator.reallocate`` (``survivor_allocations``).  Between the
  death and the shrink, the rounds' ``live`` mask shuts the dead pod out of
  gates, wire and merge, so the masked and the shrunk state are bitwise
  one for the survivors: ``drop_pod_equivalence`` asserts exactly that.

* **In-flight pod grow** (``elastic_grow`` + ``rejoin_pod_equivalence``):
  the inverse.  A recovered pod appends one row to every stacked tree
  (``grow_pod_tree``: pod_params seeded from ``w_global``, a fresh gate
  row, a zero residual), gated by the re-admission policy
  (``core.allocator.should_readmit``), and the data re-split seeds it at
  the median observed time (``rejoin_allocations``).  Its empty loss queue
  keeps its gate shut while it warms up, so the join is invisible to the
  incumbents: ``rejoin_pod_equivalence`` asserts that shrink then grow is
  bitwise the run that never resized, and ``cluster_resize_cycle_equivalence``
  repeats the cycle on the two-tier round.

Placed (``groups``, a ``launch.mesh.PodGroups``), a rank holds its own pod
rows and ``keep`` stays the GLOBAL pod indices.  A shrink moves no data:
each survivor keeps its rows and the survivors form a new pod group
(``launch.mesh.shrink_groups``); a rank whose every row died gets ``(None,
None)`` and issues no collective of the survivors' groups.  A grow builds
the regrown group (``launch.mesh.grow_groups``), broadcasts the unstacked
state (``w_global`` and any other unstacked key) from group rank 0 in one
collective, and the newcomer builds its rows on its own rank.  The
reference's ``specs`` (a PartitionSpec tree steering each key's
``device_put``) has no counterpart: eager placement is by rank rows.  Like
the reference's SPMD program, every process runs every round, the dead
pod's too (masked): a process that has truly died would need a
re-rendezvous, which neither package has.  ``launch.placed_audit``'s
elastic cases hold the placed resize against the never-resized rounds.

* **Checkpoint restart onto a smaller mesh** (``run_demo``, the
  reference's coarse path): spawned gloo ranks train qwen3-8b's smoke
  model on a ``(data, model)`` torch ``DeviceMesh``, its state DTensors
  placed by ``dist/sharding.py``'s rules bound to the mesh, checkpoint
  it whole and restore it onto a mesh of half the ranks, every leaf
  placed by the smaller mesh's rules (``checkpoint.restore_tree(
  shardings=)``).
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.config import HermesConfig
from repro_torch.core.allocator import (
    Allocation, reallocate, rejoin_gain_rounds, should_readmit,
)
from repro_torch.dist.hermes_sync import (
    hermes_cluster_commit, hermes_cluster_round, hermes_grow_pod_state,
    hermes_pod_state, hermes_round,
)
from repro_torch.launch.mesh import (
    Layout, PodGroups, grow_groups, placed, shrink_groups, shrink_layout,
)
from repro_torch.utils.trees import (
    tree_flatten, tree_leaves, tree_map, tree_unflatten,
)

Tree = Any
#: ``pod_noise(ids)``: the int4 noise of a round whose stacked rows are the
#: original pods ``ids`` (None: the round's default noise)
PodNoise = Optional[Callable[[Sequence[int]], Any]]


# ---------------------------------------------------------------------------
# Pod-stacked state migration
# ---------------------------------------------------------------------------

def _check_keep(keep: Sequence[int], n_pods: Optional[int]) -> list:
    keep = [int(k) for k in keep]
    if n_pods is not None:
        bad = [k for k in keep if not 0 <= k < n_pods]
        if bad:
            raise ValueError(
                f"pod indices {bad} out of range for leading axis "
                f"{n_pods} (stale membership table?)")
    if len(set(keep)) != len(keep):
        raise ValueError(f"duplicate pod indices in keep={keep}: a "
                         f"survivor row must not be forked")
    return keep


def shrink_pod_tree(tree: Tree, keep: Sequence[int]) -> Tree:
    """Drop dead pods from a pod-stacked tree: every leaf keeps only the
    ``keep`` rows of its leading (n_pods,) axis, in ``keep`` order.  Ring
    buffers, counters, residuals and the replicas all carry their pod
    identity in axis 0, so surviving state moves by index and nothing is
    re-derived.  ``keep`` is validated first (out-of-range or duplicate
    indices raise): a corrupted membership table must fail loudly, not
    fork a replica."""
    if tree is None:
        return None
    leaves = tree_leaves(tree)
    keep = _check_keep(keep, leaves[0].shape[0] if leaves else None)
    if not leaves:
        return tree
    idx = torch.as_tensor(keep, dtype=torch.long, device=leaves[0].device)
    return tree_map(lambda x: x.index_select(0, idx.to(x.device)), tree)


# state keys the resize paths treat as pod-stacked (leading n_pods axis)
POD_STACKED_KEYS = ("pod_params", "gup", "error")


def _n_pods(state: Dict[str, Any], groups: Optional[PodGroups]
            ) -> Optional[int]:
    """The pod count: the groups', else the leading axis of the first
    stacked tree (None: the state holds none)."""
    if groups is not None:
        return groups.n_pods
    for k in POD_STACKED_KEYS:
        if state.get(k) is not None:
            return int(tree_leaves(state[k])[0].shape[0])
    return None


def flush_pending(state: Dict[str, Any], *,
                  cfg: Optional[HermesConfig] = None,
                  live: Optional[Sequence[bool]] = None,
                  groups: Optional[PodGroups] = None,
                  n_clusters: Optional[int] = None,
                  cluster_sizes: Optional[Sequence[int]] = None
                  ) -> Dict[str, Any]:
    """Commit an async in-flight payload before a membership resize.

    The pipelined loop carries a ``pending`` buffer, a dispatched but
    unmerged round sized to the *current* pod count: a resize would orphan
    it, and merging it afterwards would let a dead pod's push land
    posthumously.  The rule is **flush first, under the survivor mask**:
    the commit (``hermes_cluster_commit``, which takes a flat buffer
    through the flat commit) re-masks the dispatch-time gates with
    ``live``, so a dropped pod's row weighs zero and is not refreshed,
    while the survivors' pushes land as a synchronous round would have
    merged them; a two-tier buffer drops the whole cluster of a dead gated
    pod.  Placed, the payload was gathered at dispatch and the commit
    issues no collective.  Returns ``state`` with ``pod_params`` /
    ``w_global`` committed and ``pending`` cleared; a state with no
    pending buffer passes through untouched."""
    pending = state.get("pending")
    if pending is None:
        return state
    cfg = cfg or HermesConfig()
    lv = None if live is None else torch.as_tensor(
        np.asarray(live, bool), device=pending["gates"].device)
    cm = hermes_cluster_commit(state["pod_params"], pending,
                               state["w_global"], cfg=cfg,
                               n_clusters=n_clusters,
                               cluster_sizes=cluster_sizes, live=lv,
                               groups=groups)
    return {**state, "pod_params": cm["pod_params"],
            "w_global": cm["w_global"], "pending": None}


def _shrink_args(groups: PodGroups, keep: Sequence[int],
                 cluster: Optional[int]):
    """``(local, kw, layout)``: ``shrink_groups``'s arguments for a shrink
    to the GLOBAL rows ``keep`` (with ``cluster=c`` on a two-tier group,
    the kept pods within cluster ``c``, after refusing a drop outside it)
    and the survivors' layout, validated."""
    keep = _check_keep(keep, groups.n_pods)
    local, kw = keep, {}
    if cluster is not None and groups.n_clusters > 1:
        n_pods, C = groups.n_pods, groups.n_clusters
        ppc = n_pods // C
        if not 0 <= cluster < C:
            raise ValueError(f"cluster {cluster} of {C}")
        lo, hi = cluster * ppc, (cluster + 1) * ppc
        outside = [k for k in range(n_pods)
                   if not lo <= k < hi and k not in keep]
        if outside:
            raise ValueError(
                f"cluster={cluster} shrink but pods {outside} outside "
                f"that cluster are also dropped; the failure domain "
                f"must stay cluster-local")
        local, kw = sorted(k - lo for k in keep if lo <= k < hi), \
            {"cluster": cluster}
    return local, kw, shrink_layout(groups.layout, local,
                                    n_clusters=groups.n_clusters, **kw)


def survivor_layout(groups: PodGroups, keep: Sequence[int], *,
                    cluster: Optional[int] = None) -> Layout:
    """The layout of the group :func:`elastic_shrink` builds from
    ``groups`` for the GLOBAL rows ``keep``, on any rank: what a rank
    whose rows died passes to :func:`elastic_grow` when it rejoins."""
    return _shrink_args(groups, keep, cluster)[2]


def elastic_shrink(state: Dict[str, Any], keep: Sequence[int],
                   groups: Optional[PodGroups], *,
                   cfg: Optional[HermesConfig] = None,
                   cluster: Optional[int] = None
                   ) -> Tuple[Optional[Dict[str, Any]], Optional[PodGroups]]:
    """Resize the Level-B state from ``n_pods`` to ``len(keep)`` pods.

    ``state`` holds the pod-stacked trees (any of ``POD_STACKED_KEYS``;
    ``None`` entries pass through) and unstacked globals under other keys
    (kept as they are).  Refuses to shrink below ``cfg.min_live_pods``.
    ``groups=None`` runs unplaced: every stacked tree keeps the ``keep``
    rows.  Placed, each survivor keeps its own rows (the module
    docstring); a rank whose every row died gets ``(None, None)``.

    On a two-tier group the failure domain is cluster-local: ``cluster=c``
    refuses a shrink that drops a pod outside cluster ``c`` (``keep`` stays
    GLOBAL rows), and the survivors form the *flat* group in cluster-major
    order: rounds run single-tier, or unplaced with uneven
    ``cluster_sizes``, until a grow rebalances the grid.  Unplaced, or on
    a flat group, ``cluster`` is not read, as in the reference.

    An async ``pending`` buffer is flushed first under the survivor mask
    (:func:`flush_pending`).  Returns ``(new_state, survivors' groups)``."""
    cfg = cfg or HermesConfig()
    keep = list(keep)
    if len(keep) < cfg.min_live_pods:
        raise ValueError(
            f"shrinking to {len(keep)} pods violates min_live_pods="
            f"{cfg.min_live_pods}")
    n_pods = _n_pods(state, groups)
    keep = _check_keep(keep, n_pods)
    if groups is not None:
        # every rank validates before any collective
        local, kw, _ = _shrink_args(groups, keep, cluster)
    if state.get("pending") is not None:
        live = np.zeros((n_pods,), bool)
        live[np.asarray(keep, int)] = True
        state = flush_pending(state, cfg=cfg, live=live, groups=groups)
    if groups is None:
        return {k: shrink_pod_tree(v, keep) if k in POD_STACKED_KEYS else v
                for k, v in state.items()}, None
    new_groups = shrink_groups(groups, local, **kw)
    if new_groups is None:
        return None, None
    return dict(state), new_groups


def grow_pod_tree(tree: Tree, new_row: Tree, n_new: int = 1) -> Tree:
    """Append ``n_new`` copies of an unstacked ``new_row`` tree to every
    leaf's leading (n_pods,) axis: the inverse of :func:`shrink_pod_tree`.
    The newcomer's replica is ``w_global`` (it starts where a refreshing
    pod would), its gate row is fresh (``hermes_grow_pod_state``) and its
    residual zero (it has dropped nothing yet)."""
    if tree is None:
        return None
    return tree_map(
        lambda x, r: torch.cat(
            [x, r[None].expand((n_new,) + tuple(x.shape[1:])).to(x.dtype)],
            dim=0), tree, new_row)


def _broadcast_unstacked(state: Dict[str, Any], groups: PodGroups
                         ) -> Dict[str, Any]:
    """Every unstacked tensor tree of ``state`` from group rank 0 to the
    rest of ``groups``'s pod group, as ONE broadcast of their bytes.  The
    receivers adopt what arrives (an incumbent's copy is bitwise the
    sender's already); a newcomer's ``state`` gives only the shapes."""
    keys = [k for k, v in state.items()
            if k not in POD_STACKED_KEYS and k != "pending" and v is not None]
    flat = {k: tree_flatten(state[k]) for k in keys}
    leaves = [x for k in keys for x in flat[k][0]]
    if not leaves:
        return state
    sizes = [x.numel() * x.element_size() for x in leaves]
    if groups.rank == 0:
        buf = torch.cat([x.contiguous().reshape(-1).view(torch.uint8)
                         for x in leaves])
    else:
        buf = torch.empty(sum(sizes), dtype=torch.uint8,
                          device=leaves[0].device)
    dist.broadcast(buf, src=groups.members[0], group=groups.pod)
    if groups.rank == 0:
        return state
    out, at = dict(state), 0
    for k in keys:
        got = []
        for x in flat[k][0]:
            n = x.numel() * x.element_size()
            part = buf[at:at + n]
            if at % x.element_size():
                part = part.clone()
            got.append(part.view(x.dtype).reshape(x.shape))
            at += n
        out[k] = tree_unflatten(flat[k][1], got)
    return out


def elastic_grow(state: Dict[str, Any], groups: Optional[PodGroups], *,
                 cfg: Optional[HermesConfig] = None,
                 remaining_rounds: Optional[float] = None,
                 n_clusters: Optional[int] = None,
                 layout: Optional[Layout] = None
                 ) -> Tuple[Dict[str, Any], Optional[PodGroups]]:
    """Re-admit one pod: the inverse of :func:`elastic_shrink`.

    Every pod-stacked tree gains one row: ``pod_params`` seeded from
    ``state["w_global"]``, ``gup`` a fresh gate row
    (``hermes_grow_pod_state``), ``error`` exact zeros.
    ``remaining_rounds`` gates it through the re-admission policy
    (``core.allocator.should_readmit``): a rejoin pays a stall worth
    ``cfg.rejoin_cost_rounds`` rounds, so with too little work left the
    grow refuses; ``None`` bypasses the policy (the caller decided).

    An async ``pending`` buffer is flushed first, every incumbent live:
    committing before the append keeps the newcomer out of a merge it
    never dispatched into.

    Placed: every process calls it.  An incumbent passes its ``groups``;
    the newcomer passes ``groups=None``, the incumbents' ``layout`` and,
    as ``state``, a template whose keys and unstacked trees give the
    structure, shapes and dtypes (its values are not read).  The
    newcomer's rank (one rank's rows, appended at the END of the pod
    order) joins the regrown group (``launch.mesh.grow_groups``, which
    regroups into ``n_clusters`` tiers: shrink(the last pod of the last
    cluster) then grow(n_clusters=C) is exact), the unstacked state is
    broadcast from group rank 0 in one collective, and the newcomer
    builds its rows on its own rank.  Returns ``(new_state, regrown
    groups)``."""
    cfg = cfg or HermesConfig()
    newcomer = groups is None and layout is not None
    if state.get("pending") is not None and not newcomer:
        state = flush_pending(state, cfg=cfg, groups=groups)
    n_pods = layout[1] if newcomer else _n_pods(state, groups)
    if remaining_rounds is not None and not should_readmit(
            remaining_rounds, n_pods, cfg):
        raise ValueError(
            f"re-admission denied: expected gain "
            f"{rejoin_gain_rounds(n_pods, remaining_rounds):.2f} rounds "
            f"does not amortize rejoin_cost_rounds={cfg.rejoin_cost_rounds}")

    # the newcomer's row per pod-stacked key; a key added to
    # POD_STACKED_KEYS without a seeding rule here must fail loudly, not
    # pass through with a mismatched row count
    if groups is None and not newcomer:
        w_global = state["w_global"]
        new_row = {
            "pod_params": lambda: w_global,
            "gup": None,  # hermes_grow_pod_state: a fresh row
            "error": lambda: tree_map(torch.zeros_like, w_global),
        }
        out: Dict[str, Any] = {}
        for k, v in state.items():
            if v is not None and k in POD_STACKED_KEYS:
                v = (hermes_grow_pod_state(v, cfg) if k == "gup"
                     else grow_pod_tree(v, new_row[k]()))
            out[k] = v
        return out, None
    new_groups = grow_groups(groups, 1, n_clusters=n_clusters, layout=layout)
    if new_groups is None:  # a process in neither group
        return state, None
    out = _broadcast_unstacked(state, new_groups)
    if newcomer:
        rpr = new_groups.rows_per_rank
        w_global = out["w_global"]
        dev = tree_leaves(w_global)[0].device

        def stacked(fill):
            return tree_map(lambda g: fill(g)[None].expand(
                (rpr,) + tuple(g.shape)).clone(), w_global)

        rows = {
            "pod_params": lambda: stacked(lambda g: g),
            "gup": lambda: hermes_pod_state(cfg, rpr, dev),
            "error": lambda: stacked(torch.zeros_like),
        }
        for k in POD_STACKED_KEYS:
            if out.get(k) is not None:
                out[k] = rows[k]()
        if "pending" in out:
            out["pending"] = None
    return out, new_groups


def rejoin_allocations(times: Dict[str, float],
                       allocs: Dict[str, Allocation],
                       newcomer: str, cfg: HermesConfig, *,
                       n_train: int,
                       mem_limit_dss: Optional[Dict[str, int]] = None
                       ) -> Dict[str, Allocation]:
    """Re-split the data shards after a membership grow.  The newcomer has
    no fresh iteration time, so it enters the allocator's sweep at the
    **median** observed time with a median-sized allocation; one
    ``reallocate`` round then re-sizes any member the IQR sweep flags
    against the larger membership.  Returns an allocation for everyone."""
    assert times, "rejoin with no surviving observations"
    med_t = float(np.median(list(times.values())))
    med_dss = int(np.median([a.dss for a in allocs.values()]))
    med_mbs = int(np.median([a.mbs for a in allocs.values()]))
    times = {**times, newcomer: med_t}
    allocs = {**allocs, newcomer: Allocation(med_dss, med_mbs)}
    dss_hi = max(64, n_train // max(1, len(times)))
    new = reallocate(times, allocs, cfg, dss_domain=(32, dss_hi),
                     mem_limit_dss=dict(mem_limit_dss or {}))
    return {**allocs, **new}


def survivor_allocations(times: Dict[str, float],
                         allocs: Dict[str, Allocation],
                         dead: Sequence[str], cfg: HermesConfig, *,
                         n_train: int,
                         mem_limit_dss: Optional[Dict[str, int]] = None
                         ) -> Dict[str, Allocation]:
    """Re-split the data shards for the survivors of a membership change.
    Dead members leave the observation set *before* the IQR sweep (a stale
    entry would keep skewing the fences and billing a node that will never
    run again); ``reallocate`` then re-sizes the survivors toward the new
    median.  Returns an allocation for every survivor and no dead one."""
    dead_set = set(dead)
    live_times = {k: v for k, v in times.items() if k not in dead_set}
    live_allocs = {k: v for k, v in allocs.items() if k not in dead_set}
    dss_hi = max(64, n_train // max(1, len(live_times)))
    new = reallocate(live_times, live_allocs, cfg,
                     dss_domain=(32, dss_hi),
                     mem_limit_dss={k: v for k, v in
                                    (mem_limit_dss or {}).items()
                                    if k not in dead_set})
    return {**live_allocs, **new}


# ---------------------------------------------------------------------------
# The equivalence harnesses
# ---------------------------------------------------------------------------

def _toy_pod_state(n_pods: int, cfg: HermesConfig, seed: int = 0,
                   device="cpu") -> Tuple[Tree, Tree, Tree]:
    """Per-pod-distinct toy replicas: one blocked leaf, one padded leaf
    (drawn from a ``torch.Generator`` on ``device``)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pod_params = {
        "w": torch.randn((n_pods, 4, 512), generator=gen, device=dev),
        "b": torch.randn((n_pods, 7), generator=gen, device=dev),
    }
    w_global = {"w": torch.randn((4, 512), generator=gen, device=dev),
                "b": torch.zeros((7,), device=dev)}
    return pod_params, w_global, hermes_pod_state(cfg, n_pods, dev)


def _demo_losses(n_pods: int, r: int) -> np.ndarray:
    """Deterministic per-pod loss schedule with sharp per-pod drops so the
    z-score gates open on different rounds for different pods."""
    base = 1.0 + 0.05 * np.cos(np.arange(n_pods) + r)
    drop = (np.arange(n_pods) + 3 == r % 7).astype(np.float64) * 0.8
    return (base - drop).astype(np.float32)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal element for element, NaN matching NaN (numpy's
    ``assert_array_equal``, which the reference's proofs use)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _check(name: str, a: Tree, b: Tree, what: str) -> None:
    if a is None or b is None:
        if a is not b:
            raise AssertionError(f"{name}: {what}")
        return
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb) or not all(_same(x, y) for x, y in zip(la, lb)):
        raise AssertionError(f"{name}: {what}")


def _poison(tree: Tree, row: int) -> Tree:
    """``tree`` with stacked row ``row`` set to NaN (out of place)."""
    def put(x):
        x = x.clone()
        x[row] = float("nan")
        return x
    return tree_map(put, tree)


def _reseed(st: Dict[str, Any], row: int, fresh: Dict[str, torch.Tensor]
            ) -> Dict[str, Any]:
    """The never-resized oracle's rejoin: stacked row ``row`` re-seeded in
    place with the newcomer's state (pod_params = ``w_global``, a fresh
    gate row, a zero residual)."""
    def put(x, v):
        x = x.clone()
        x[row] = v.to(x.dtype)
        return x
    return {"pods": tree_map(put, st["pods"], st["wg"]),
            "gup": tree_map(put, st["gup"], fresh),
            "err": None if st["err"] is None else tree_map(
                lambda x: put(x, torch.zeros((), device=x.device)), st["err"]),
            "wg": st["wg"]}


class _Rounds:
    """The harnesses' round loop: ``_demo_losses`` of the rows' original
    pods, dead pods' losses NaN, the membership mask, ``round_step`` the
    round index, on ``groups`` (this rank's rows) or unplaced.  ``merged``
    collects the host's flag of every round run."""

    def __init__(self, cfg: HermesConfig, n_pods: int, dev: torch.device,
                 pod_noise: PodNoise = None):
        self.cfg, self.n_pods, self.dev = cfg, n_pods, dev
        self.pod_noise = pod_noise
        self.L = torch.ones((), dtype=torch.float32, device=dev)
        self.merged: list = []

    def inputs(self, r: int, ids: Sequence[int], live=None, groups=None):
        """Round ``r``'s ``(losses of this rank's rows, live mask, noise)``
        for stacked rows holding the original pods ``ids``."""
        ids = list(ids)
        lv = (np.ones((len(ids),), bool) if live is None
              else np.asarray(live, bool))
        rows = groups.rows if placed(groups) else slice(None)
        losses = np.where(lv, _demo_losses(self.n_pods, r)[ids], np.nan)
        return (torch.as_tensor(losses[rows], device=self.dev),
                torch.as_tensor(lv, device=self.dev),
                None if self.pod_noise is None else self.pod_noise(ids))

    def __call__(self, st: Dict[str, Any], n: int, start: int,
                 ids: Sequence[int], *, live=None, groups=None,
                 two_tier: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
        if st is None:  # a rank whose rows died runs nothing
            return None
        for r in range(start, start + n):
            losses, lv, noise = self.inputs(r, ids, live, groups)
            kw = dict(live=lv, error=st["err"], round_step=r, noise=noise,
                      groups=groups)
            if two_tier is None:
                out = hermes_round(st["pods"], st["gup"], losses, st["wg"],
                                   self.L, self.cfg, **kw)
            else:
                out = hermes_cluster_round(st["pods"], st["gup"], losses,
                                           st["wg"], self.L, self.cfg,
                                           **two_tier, **kw)
            self.merged.append(out["merged"])
            st = {"pods": out["pod_params"], "gup": out["gup"],
                  "err": out["error"], "wg": out["w_global"]}
        return st


def _as_state(st: Dict[str, Any]) -> Dict[str, Any]:
    return {"pod_params": st["pods"], "gup": st["gup"], "error": st["err"],
            "w_global": st["wg"]}


def _from_state(state: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if state is None:
        return None
    return {"pods": state["pod_params"], "gup": state["gup"],
            "err": state["error"], "wg": state["w_global"]}


def _start(n_pods, cfg, seed, dev, init_state, groups):
    """The common starting state, this rank's rows when placed."""
    pods, wg, gup = (init_state or _toy_pod_state)(n_pods, cfg, seed, dev)
    st = {"pods": pods, "gup": gup, "err": None, "wg": wg}
    if placed(groups):
        if groups.n_pods != n_pods:
            raise ValueError(f"groups hold {groups.n_pods} pods, the "
                             f"harness {n_pods}")
        rows = groups.rows
        st["pods"] = tree_map(lambda x: x[rows], pods)
        st["gup"] = tree_map(lambda x: x[rows], gup)
    return st


def _local(groups: Optional[PodGroups], row: int) -> Optional[int]:
    """Where global pod row ``row`` sits in this rank's stacking (None: on
    another rank)."""
    if not placed(groups):
        return row
    rows = groups.rows
    return row - rows.start if rows.start <= row < rows.stop else None


def _size(groups: Optional[PodGroups]) -> Optional[int]:
    return None if groups is None else groups.size


def drop_pod_equivalence(*, n_pods: int = 2, drop: int = 1,
                         rounds_before: int = 4, rounds_after: int = 4,
                         groups: Optional[PodGroups] = None,
                         cfg: Optional[HermesConfig] = None,
                         seed: int = 0, device="cuda",
                         init_state=None, pod_noise: PodNoise = None
                         ) -> Dict[str, Any]:
    """Kill pod ``drop`` mid-run; prove the survivors never notice.

    Path A (what production does): ``rounds_before`` full-membership
    rounds, poison the dead pod with NaNs, one masked round (``live[drop]
    = False``), ``elastic_shrink``, then ``rounds_after`` rounds at the
    reduced pod count.  Path B (the oracle): shrink *at the moment of
    death* and run the same rounds at the smaller size from the start.
    Every surviving tensor (pod_params, w_global, gate state, residual)
    must match **bitwise** between the two, which is the claim that a
    masked round zeroes the dead pod out of gates, wire and merge.

    ``groups=None`` runs unplaced on ``device``; placed, every rank runs
    both paths on its rows (the shrunk groups built twice) and checks its
    own.  ``init_state(n_pods, cfg, seed, device) -> (pod_params,
    w_global, gup)`` replaces the toy state; ``pod_noise`` gives the int4
    noise of the current rows (int4 is not resize-invariant by default:
    its dither is drawn over the whole stacked shape)."""
    cfg = cfg or HermesConfig(alpha=-0.5, beta=0.1, lam=2, window=4,
                              compression="int8")
    assert 0 <= drop < n_pods and n_pods >= 2
    keep = [i for i in range(n_pods) if i != drop]
    dev = resolve_device(device)
    rounds = _Rounds(cfg, n_pods, dev, pod_noise)
    full = list(range(n_pods))

    st = _start(n_pods, cfg, seed, dev, init_state, groups)
    st = rounds(st, rounds_before, 0, full, groups=groups)
    snap = dict(st)  # the rounds never write in place

    # path A: pod `drop` dies (NaN replica), one masked round, then shrink
    live = np.ones((n_pods,), bool)
    live[drop] = False
    mine = _local(groups, drop)
    a = dict(st)
    if mine is not None:
        a["pods"] = _poison(a["pods"], mine)
    a = rounds(a, 1, rounds_before, full, live=live, groups=groups)
    a_state, a_groups = elastic_shrink(_as_state(a), keep, groups, cfg=cfg)
    a = rounds(_from_state(a_state), rounds_after, rounds_before + 1, keep,
               groups=a_groups)

    # path B: shrink at the moment of death, replay the same rounds small
    b_state, b_groups = elastic_shrink(_as_state(snap), keep, groups,
                                       cfg=cfg)
    b = rounds(_from_state(b_state), 1 + rounds_after, rounds_before, keep,
               groups=b_groups)

    if a is not None:
        for name, key in (("pod_params", "pods"), ("gup", "gup"),
                          ("error", "err"), ("w_global", "wg")):
            _check(name, a[key], b[key],
                   "surviving state diverged after the pod drop")
    return {
        "n_pods": n_pods, "dropped": drop, "survivors": keep,
        "group": _size(groups), "survivor_group": _size(a_groups),
        "rounds": rounds_before + 1 + rounds_after,
        "compression": cfg.compression,
        "bit_identical": True,
    }


def rejoin_pod_equivalence(*, n_pods: int = 2, rounds_before: int = 3,
                           rounds_shrunk: int = 3, rounds_after: int = 4,
                           groups: Optional[PodGroups] = None,
                           cfg: Optional[HermesConfig] = None,
                           seed: int = 0, device="cuda",
                           init_state=None, pod_noise: PodNoise = None
                           ) -> Dict[str, Any]:
    """Kill the last pod mid-run, shrink, then re-admit a pod; prove the
    incumbents never notice either resize.

    Path A (what production does): ``rounds_before`` full rounds, poison
    the last pod, one masked round, ``elastic_shrink``, ``rounds_shrunk``
    rounds at ``n_pods - 1``, ``elastic_grow`` (policy-gated), then
    ``rounds_after`` rounds at ``n_pods``.  Path B (the oracle, *never
    resized*): the same rounds on all ``n_pods`` rows, the dead stretch
    live-masked, the dead row re-seeded in place with the newcomer's
    state at the rejoin.  Every tensor must match **bitwise**.

    Path C: the shrunk run continues at ``n_pods - 1`` with no grow.  For
    the first ``min(2, rounds_after)`` rounds after the join the
    newcomer's gate cannot open (fewer than two losses queued), so the
    incumbents' state in A must be bitwise C's.  As in the reference this
    cross-pod-count check runs only unplaced; placed, path B carries the
    proof.  The dropped pod is the last row, so A's appended row sits
    where B's re-seeded one does.

    ``groups``, ``device``, ``init_state`` and ``pod_noise`` as in
    :func:`drop_pod_equivalence`; placed, the newcomer is the dead pod's
    own rank (``elastic_grow``'s newcomer, its pre-shrink state the
    template)."""
    cfg = cfg or HermesConfig(alpha=-0.5, beta=0.1, lam=2, window=4,
                              compression="int8", rejoin_cost_rounds=0.5)
    assert n_pods >= 2
    drop = n_pods - 1
    keep = list(range(n_pods - 1))
    dev = resolve_device(device)
    rounds = _Rounds(cfg, n_pods, dev, pod_noise)
    full = list(range(n_pods))

    # common prefix: full membership, then the masked death round
    st = _start(n_pods, cfg, seed, dev, init_state, groups)
    st = rounds(st, rounds_before, 0, full, groups=groups)
    live = np.ones((n_pods,), bool)
    live[drop] = False
    mine = _local(groups, drop)
    if mine is not None:
        st["pods"] = _poison(st["pods"], mine)
    st = rounds(st, 1, rounds_before, full, live=live, groups=groups)

    # path A: shrink -> shrunk rounds -> grow (policy-gated) -> rounds
    a_state, a_groups = elastic_shrink(_as_state(st), keep, groups, cfg=cfg)
    start_after = rounds_before + 1 + rounds_shrunk
    a = rounds(_from_state(a_state), rounds_shrunk, rounds_before + 1, keep,
               groups=a_groups)
    gain = rejoin_gain_rounds(n_pods - 1, float(rounds_after))
    outside = groups is not None and a_groups is None
    g_state, g_groups = elastic_grow(
        _as_state(st) if outside else _as_state(a), a_groups, cfg=cfg,
        remaining_rounds=float(rounds_after),
        layout=survivor_layout(groups, keep) if outside else None)
    warm = min(2, rounds_after)
    a = rounds(_from_state(g_state), warm, start_after, full,
               groups=g_groups)
    a_warm = dict(a)
    a = rounds(a, rounds_after - warm, start_after + warm, full,
               groups=g_groups)

    # path B: never resize; masked rounds, then re-seed the row in place
    b = rounds(st, rounds_shrunk, rounds_before + 1, full, live=live,
               groups=groups)
    if mine is not None:
        b = _reseed(b, mine, hermes_pod_state(cfg, 1, dev))
    b = rounds(b, rounds_after, start_after, full, groups=groups)

    for name, key in (("pod_params", "pods"), ("gup", "gup"),
                      ("error", "err"), ("w_global", "wg")):
        _check(name, a[key], b[key],
               "state diverged across the shrink->grow round trip")
    # path C, unplaced only: the join never moved the incumbents
    warmup_checked = groups is None
    if warmup_checked:
        c = rounds(_from_state(a_state), rounds_shrunk + warm,
                   rounds_before + 1, keep)
        _check("warmup w_global", a_warm["wg"], c["wg"],
               "the join moved the incumbents")
        _check("warmup survivors",
               tree_map(lambda x: x[:n_pods - 1], a_warm["pods"]), c["pods"],
               "the join moved the incumbents")
    return {
        "n_pods": n_pods, "rejoined": drop, "incumbents": keep,
        "group": _size(groups), "shrunk_group": _size(a_groups),
        "regrown_group": _size(g_groups),
        "rounds": rounds_before + 1 + rounds_shrunk + rounds_after,
        "compression": cfg.compression,
        "readmission": {"admitted": True, "gain_rounds": gain,
                        "rejoin_cost_rounds": cfg.rejoin_cost_rounds},
        "bit_identical": True,
        "warmup_checked": warmup_checked,
    }


def cluster_resize_cycle_equivalence(*, n_pods: int = 4, n_clusters: int = 2,
                                     cycles: int = 3, rounds_full: int = 2,
                                     rounds_shrunk: int = 2,
                                     cfg: Optional[HermesConfig] = None,
                                     seed: int = 0, device="cuda"
                                     ) -> Dict[str, Any]:
    """Repeated cluster-local shrink -> grow cycles leave no scar.

    The two-tier analogue of :func:`rejoin_pod_equivalence`, iterated: in
    every cycle the LAST pod of the LAST cluster dies (one masked two-tier
    round), the state shrinks, runs ``rounds_shrunk`` rounds on the
    uneven split ``cluster_sizes=[ppc, ..., ppc-1]``, grows back and
    resumes the balanced grid; at least three cycles, so a scar left by
    cycle k compounds and surfaces by cycle k+1.  Path B never resizes:
    every round at ``n_pods`` rows, the dead stretch live-masked, the dead
    row re-seeded in place at each grow.  Every tensor must match
    **bitwise** at every cycle: a masked member costs its cluster an exact
    ``+0.0`` term, so the uneven split and the masked balanced split ship
    the same cluster payloads.  Unplaced, as in the reference (uneven
    clusters run unplaced only); ``launch.placed_audit``'s
    ``cluster_resize`` case runs the placed cycle."""
    cfg = cfg or HermesConfig(alpha=-0.5, beta=0.1, lam=2, window=4,
                              compression="int8", min_live_pods=1,
                              rejoin_cost_rounds=0.0,
                              n_clusters=n_clusters)
    assert n_pods % n_clusters == 0 and n_pods // n_clusters >= 1
    assert cycles >= 3, "fewer cycles cannot catch compounding scars"
    ppc = n_pods // n_clusters
    drop = n_pods - 1          # last pod of the last cluster
    keep = list(range(n_pods - 1))
    full = list(range(n_pods))
    sizes_shrunk = [ppc] * (n_clusters - 1) + [ppc - 1]
    if sizes_shrunk[-1] == 0:
        sizes_shrunk = sizes_shrunk[:-1]
    dev = resolve_device(device)
    rounds = _Rounds(cfg, n_pods, dev)
    balanced = {"n_clusters": n_clusters}

    a = _start(n_pods, cfg, seed, dev, None, None)
    b = dict(a)
    live_mask = np.ones((n_pods,), bool)
    live_mask[drop] = False
    fresh = hermes_pod_state(cfg, 1, dev)
    r0 = 0
    for cyc in range(cycles):
        a = rounds(a, rounds_full, r0, full, two_tier=balanced)
        b = rounds(b, rounds_full, r0, full, two_tier=balanced)
        r0 += rounds_full
        # death: poison + one masked balanced round, both paths
        a, b = [rounds({**s, "pods": _poison(s["pods"], drop)}, 1, r0, full,
                       live=live_mask, two_tier=balanced) for s in (a, b)]
        r0 += 1
        # path A shrinks to the uneven split; path B stays masked
        st, _ = elastic_shrink(_as_state(a), keep, None, cfg=cfg)
        a = rounds(_from_state(st), rounds_shrunk, r0, keep,
                   two_tier={"cluster_sizes": sizes_shrunk})
        b = rounds(b, rounds_shrunk, r0, full, live=live_mask,
                   two_tier=balanced)
        r0 += rounds_shrunk
        # grow back to the balanced grid; the oracle re-seeds in place
        st, _ = elastic_grow(_as_state(a), None, cfg=cfg)
        a = _from_state(st)
        b = _reseed(b, drop, fresh)
        for name in ("pods", "gup", "err", "wg"):
            _check(name, a[name], b[name],
                   f"cycle {cyc}: resize cycle left a scar vs the "
                   f"never-resized oracle")
    return {
        "n_pods": n_pods, "n_clusters": n_clusters, "cycles": cycles,
        "rounds": r0, "compression": cfg.compression,
        "shrunk_cluster_sizes": sizes_shrunk,
        "bit_identical": True,
    }


def run_hermes_cluster_resize_demo(n_pods: int = 4, n_clusters: int = 2,
                                   seed: int = 0, device="cuda"
                                   ) -> Dict[str, Any]:
    """Three shrink -> grow -> shrink cycles on the two-tier round, checked
    bitwise against the never-resized masked oracle per cycle."""
    return cluster_resize_cycle_equivalence(
        n_pods=n_pods, n_clusters=n_clusters, cycles=3, seed=seed,
        device=device)


def run_hermes_rejoin_demo(n_pods: int = 4, seed: int = 0, device="cuda"
                           ) -> Dict[str, Any]:
    """The in-flight pod-join demo: shrink -> grow equivalence, policy
    decisions, and the newcomer's data re-split.  Unplaced, at ``n_pods``
    as given (the reference caps it at its device count)."""
    cfg = HermesConfig(alpha=-0.5, beta=0.1, lam=2, window=4,
                       compression="int8", min_live_pods=1,
                       rejoin_cost_rounds=0.5)
    n_pods = max(2, n_pods)
    out = rejoin_pod_equivalence(n_pods=n_pods, cfg=cfg, seed=seed,
                                 device=device)
    # the allocator folds the newcomer in at the median observed time
    times = {f"pod{i}": 1.0 + 0.4 * i for i in range(n_pods - 1)}
    allocs = {f"pod{i}": Allocation(256, 16) for i in range(n_pods - 1)}
    new = rejoin_allocations(times, allocs, f"pod{n_pods - 1}", cfg,
                             n_train=4096)
    assert f"pod{n_pods - 1}" in new
    out["realloc"] = {k: {"dss": a.dss, "mbs": a.mbs}
                      for k, a in sorted(new.items())}
    # the policy half: plenty of work left -> admit; nearly done -> deny
    out["policy"] = {
        "admit_100_rounds_left": should_readmit(100.0, n_pods - 1, cfg),
        "deny_0p5_rounds_left": not should_readmit(0.5, n_pods - 1, cfg),
    }
    assert out["policy"]["admit_100_rounds_left"]
    assert out["policy"]["deny_0p5_rounds_left"]
    return out


def run_hermes_shrink_demo(n_pods: int = 4, drop: int = 1, seed: int = 0,
                           device="cuda") -> Dict[str, Any]:
    """The in-flight pod-shrink demo: drop-pod equivalence + data re-split.
    Unplaced, at ``n_pods`` as given (the reference caps it at its device
    count)."""
    cfg = HermesConfig(alpha=-0.5, beta=0.1, lam=2, window=4,
                       compression="int8", min_live_pods=1)
    n_pods = max(2, n_pods)
    drop = min(drop, n_pods - 1)
    out = drop_pod_equivalence(n_pods=n_pods, drop=drop, cfg=cfg, seed=seed,
                               device=device)
    # the allocator re-splits the surviving members' data shards
    times = {f"pod{i}": 1.0 + 0.4 * i for i in range(n_pods)}
    allocs = {f"pod{i}": Allocation(256, 16) for i in range(n_pods)}
    new = survivor_allocations(times, allocs, [f"pod{drop}"], cfg,
                               n_train=4096)
    assert f"pod{drop}" not in new
    out["realloc"] = {k: {"dss": a.dss, "mbs": a.mbs}
                      for k, a in sorted(new.items())}
    return out


# ---------------------------------------------------------------------------
# Checkpoint-restart demo (the original coarse path)
# ---------------------------------------------------------------------------

#: the demo's (data, model) mesh axes, as the reference's
MESH_AXES = ("data", "model")


class _MeshTrainer:
    """One rank's train step of ``cfg`` on a ``(data, model)`` DeviceMesh:
    the reference's ``build_setup("train", ...)`` jitted with its
    shardings, the state donated as the port's steps donate it.

    The state is ``launch/steps.py``'s, ``{"params", "opt", "step"}``
    (with bf16 compute: bf16 parameters, fp32 ``master`` weights, ``m``
    and ``v``), every tensor a DTensor: the parameters placed by
    ``launch.mesh.arch_rules`` (heads, ff and vocab on "model" where
    they divide, the rest replicated), the optimizer state by its ZeRO-1
    rules (``steps.opt_rules``: "embed" and "qkv" over "data" too).

    A step constrains each parameter to full replication (an all-gather
    over the axes that shard it) and takes the plain tensors into the
    model: the model's ops, and the card's kernels, take plain tensors.
    The batch is constrained to its "batch" rule alone (each data row its
    rows, a local slice; the sequence stays whole, as the causal forward
    needs it), and each rank's loss and gradients are a mean over its
    rows.  A gradient is a ``Partial`` sum over "data" (in fp32), made
    whole by a redistribute to ``Replicate`` (an all-reduce: gloo has no
    reduce-scatter, so ``Partial -> Shard`` is not taken;
    ``dist.sharding.redistribute``), then sliced to
    the optimizer state's placement (no collective).  AdamW updates the
    local shards in place, and the new parameters go from the state's
    placement to theirs (an all-gather over "data" for a ZeRO-1 leaf)
    into the parameters' own tensors.  The loss is reduced as a
    gradient is."""

    def __init__(self, cfg, device_mesh, batch: int, opt_cfg):
        from repro_torch.config import ParallelConfig
        from repro_torch.dist.sharding import mesh_shape, param_sharding_tree
        from repro_torch.launch.mesh import arch_rules
        from repro_torch.launch.steps import opt_rules
        from repro_torch.models.lm import param_axes
        from repro_torch.optim.optimizers import make_optimizer
        parallel = ParallelConfig()
        self.cfg, self.mesh = cfg, device_mesh
        self.rules = arch_rules(cfg, mesh_shape(device_mesh), parallel,
                                batch=batch).bind(device_mesh)
        self.master = cfg.dtype == "bfloat16" and \
            cfg.param_dtype == "float32"
        self.optimizer = make_optimizer(opt_cfg, master_weights=self.master)
        axes = param_axes(cfg)
        self.param_sharding = param_sharding_tree(axes, self.rules)
        self.opt_sharding = param_sharding_tree(
            axes, opt_rules(self.rules, parallel))
        self.n_data = int(device_mesh.size(MESH_AXES.index("data")))

    def state_sharding(self) -> Tree:
        """The state's placements (None for the step counts)."""
        opt = {k: self.opt_sharding for k in ("m", "v")}
        if self.master:
            opt["master"] = self.opt_sharding
        return {"params": self.param_sharding,
                "opt": {"step": None, **opt}, "step": None}

    def init_state(self, seed: int, device: torch.device) -> Tree:
        """The state drawn whole (the same on every rank, from ``seed``)
        and placed."""
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.launch.steps import _init_params
        params = _init_params(self.cfg, seed, device)
        state = {"params": params, "opt": self.optimizer.init(params),
                 "step": 0}
        return tree_map(
            lambda x, sh: x if sh is None else distribute_tensor(
                x, sh.mesh, sh.placements, src_data_rank=None),
            state, self.state_sharding())

    def _whole_mean(self, x: torch.Tensor):
        """The mean over "data" of a per-data-row fp32 value, a DTensor
        whole on every rank."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        from repro_torch.dist.sharding import redistribute
        d = DTensor.from_local(x.to(torch.float32) / self.n_data, self.mesh,
                               [Partial(), Replicate()], run_check=False)
        return redistribute(d, self.mesh, [Replicate(), Replicate()])

    def step(self, state: Tree, batch: Dict[str, torch.Tensor]):
        """One step; ``state`` is donated.  Returns ``(state, loss)``."""
        from torch.distributed.tensor import DTensor
        from repro_torch.dist.sharding import constrain, redistribute
        from repro_torch.launch.train import _loss_and_grads
        full = tree_map(lambda p: constrain(p, self.rules).to_local(),
                        state["params"])
        mine = {k: constrain(v, self.rules, "batch", None).to_local()
                for k, v in batch.items()}
        loss, grads = _loss_and_grads(full, mine, self.cfg)
        del full
        grads = tree_map(
            lambda g, sh: redistribute(self._whole_mean(g), sh.mesh,
                                       sh.placements).to_local(),
            grads, self.opt_sharding)
        local = {k: v if k == "step" else tree_map(
            lambda x: x.to_local(), v) for k, v in state["opt"].items()}
        # the parameters at the optimizer state's placement: AdamW writes
        # the new ones there (the cast of the master weights)
        at_opt = tree_map(
            lambda p, sh: redistribute(p, sh.mesh, sh.placements)
            .to_local().clone(), state["params"], self.opt_sharding)
        with torch.no_grad():
            self.optimizer.apply_(at_opt, grads, local)
            for p, x, sh in zip(tree_leaves(state["params"]),
                                tree_leaves(at_opt),
                                tree_leaves(self.opt_sharding)):
                new = DTensor.from_local(
                    x, sh.mesh, sh.placements, run_check=False,
                    shape=p.shape, stride=p.stride())
                p.to_local().copy_(redistribute(
                    new, p.device_mesh, p.placements).to_local())
        state["opt"]["step"] = local["step"]
        state["step"] += 1
        return state, self._whole_mean(loss.reshape(1)).to_local()[0]


def _demo_main(rank: int, world: int, job: Dict[str, Any]
               ) -> Dict[str, Any]:
    """One rank of :func:`run_demo`: phase 1 on the full mesh, a
    checkpoint, phase 2 on the smaller mesh of the first ranks (the others
    build it too, every group creation being collective, then idle)."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.checkpoint.checkpointer import restore_tree, save_tree
    from repro_torch.dist.sharding import constrain
    from repro_torch.config import OptimizerConfig
    from repro_torch.configs import get_smoke_config
    torch.set_num_threads(job["threads"])
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)   # every rank shares the one card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke_config(job["arch"])
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    B, S = job["batch"], job["seq"]
    rng = np.random.default_rng(job["seed"])

    def batch_for():
        t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
        return {"tokens": t.to(dev), "targets": t.to(dev)}

    def make(shape):
        n = int(np.prod(shape))
        mesh = DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                          mesh_dim_names=MESH_AXES)
        return (_MeshTrainer(cfg, mesh, B, opt) if rank < n else None), n

    report: Dict[str, Any] = {"rank": rank}
    trainer, _ = make(job["mesh1"])
    state = trainer.init_state(job["seed"], dev)
    losses = []
    for _ in range(job["steps_before"]):
        state, loss = trainer.step(state, batch_for())
        losses.append(loss)
    report["phase1_losses"] = [float(x) for x in losses]
    # the whole state, gathered on every rank; rank 0 writes it
    whole = tree_map(lambda x: x if isinstance(x, int) else constrain(
        x, trainer.rules).to_local(), state)
    if rank == 0:
        save_tree(whole, job["ckpt"], job["steps_before"])
    del state, whole, trainer
    dist.barrier()

    trainer, n2 = make(job["mesh2"])
    if trainer is None:
        return report
    from repro_torch.launch.steps import _init_params
    params = _init_params(cfg, 0, torch.device("meta"))
    template = {"params": params, "opt": trainer.optimizer.init(params),
                "step": 0}
    state, at = restore_tree(template, job["ckpt"], device=dev,
                             shardings=trainer.state_sharding())
    losses = []
    for _ in range(job["steps_after"]):
        state, loss = trainer.step(state, batch_for())
        losses.append(loss)
    report.update(phase2_losses=[float(x) for x in losses],
                  resumed_from_step=at)
    return report


def run_demo(arch: str = "qwen3-8b", steps_before: int = 5,
             steps_after: int = 5, seed: int = 0, *, world: int = 8,
             device="cuda", timeout: float = 600.0,
             workdir: Optional[str] = None) -> Dict[str, Any]:
    """The reference's checkpoint-restart demo on ``world`` spawned gloo
    ranks (``launch.spawn.spawn_ranks``), each on ``device`` (ranks share
    one card).  ``arch``'s smoke model trains with AdamW (lr 1e-3, batch
    16, seq 32) on a ``(world // 4, 4)`` (data, model) DeviceMesh for
    ``steps_before`` steps; the state is checkpointed whole, as "half the
    nodes died", and restored onto a ``(max(1, world // 8), 4)`` mesh of
    the first ranks, every leaf placed by the smaller mesh's rules
    (``checkpoint.restore_tree(shardings=)``), for ``steps_after`` more
    steps on the same batch stream.  The allocator then re-balances the
    per-node work.  Returns the reference's keys: the losses and mesh
    shape of each phase, ``resumed_from_step``, ``realloc`` and
    ``loss_continuous`` (phase 2's first loss below phase 1's first)."""
    import tempfile
    from repro_torch.core.allocator import dual_binary_search
    from repro_torch.launch.spawn import spawn_ranks
    if world < 4:
        raise ValueError("need >= 4 ranks for a (data, model=4) mesh")
    dev = resolve_device(device)
    mesh1 = (world // 4, 4)
    mesh2 = (max(1, world // 8), 4)
    with tempfile.TemporaryDirectory(dir=workdir) as ckpt:
        job = {"arch": arch, "seed": seed, "batch": 16, "seq": 32,
               "steps_before": steps_before, "steps_after": steps_after,
               "mesh1": mesh1, "mesh2": mesh2, "ckpt": ckpt,
               "device": str(dev),
               "threads": max(1, torch.get_num_threads() // world)}
        reports = spawn_ranks(world, job, _demo_main, timeout=timeout,
                              workdir=workdir)
    first = reports[0]
    a = dual_binary_search(k=0.02, t_target=1.0, dss_domain=(32, 4096))
    return {"phase1_losses": first["phase1_losses"],
            "phase1_mesh": list(mesh1),
            "phase2_losses": first["phase2_losses"],
            "phase2_mesh": list(mesh2),
            "resumed_from_step": first["resumed_from_step"],
            "realloc": {"dss": a.dss, "mbs": a.mbs},
            "loss_continuous": (first["phase2_losses"][0]
                                < first["phase1_losses"][0])}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {"hermes_shrink": run_hermes_shrink_demo(device=args.device),
           "hermes_rejoin": run_hermes_rejoin_demo(device=args.device),
           "hermes_cluster_resize": run_hermes_cluster_resize_demo(
               device=args.device)}
    out["checkpoint_restart"] = run_demo(device=args.device)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
