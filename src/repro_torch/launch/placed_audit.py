"""Placed Hermes rounds against unplaced ones, on one machine.

    python -m repro_torch.launch.placed_audit --preset lm100m --ranks 4 \
        --pods 4 --clusters 2 --formats int4 int8 --train-steps 6
    python -m repro_torch.launch.placed_audit --preset toy --device cpu

The parent process runs every case unplaced, all pods in one process,
keeps a SHA-256 of each output (``w_global``, every pod row, every error
row), frees what it holds, and spawns one process per rank
(``launch.spawn.spawn_ranks``: gloo over a ``FileStore``; a rank that
fails fails the audit with its traceback), every rank's tensors on the
parent's device (one card can host them all: gloo gathers CUDA
tensors).  Each rank rebuilds the same
inputs from the seed, keeps its own pod rows, runs the same cases placed
over ``launch.mesh.make_pod_groups`` and reports whether its outputs hash
as the parent's, the host's ``merged`` flag of each round, and every
collective it issued (``analysis.collectives.count_collectives``): the
tier, dtype, per-rank dims and bytes, to be held against ``dist.wire``'s
specs.

Cases, per wire format, gates forced open by a loss history the round's
losses beat: ``flat`` (``hermes_round``), ``flat_async``
(``hermes_dispatch`` + ``hermes_commit``), ``cluster`` and
``cluster_async`` (the two-tier twins), and ``closed`` (a flat and a
two-tier round whose gates stay shut).  ``train`` runs
``train_hermes`` unplaced, then placed.  The ``toy`` preset is a small
tree with a scalar leaf, which a placed round encodes whole.

Elastic cases (``elastic=``), each a run of rounds on the loss schedule
of ``launch.elastic`` across a membership change: ``drop`` (pod 1 dies
with an async push in flight, the flush commits it under the survivor
mask, the survivors are global ranks ``[0, 2, 3]`` and their rows
renumber), ``rejoin`` (the last pod dies in a masked round, the rest run
shrunk, it grows back) and ``cluster_resize`` (4 pods in 2 clusters: the
last pod of cluster 1 dies, the groups flatten to 3 ranks, flat rounds,
``grow_groups(n_clusters=2)`` restores the two tiers, two-tier rounds).
The parent runs the never-resized oracle, every round at ``n_pods``
rows, the dead stretch live-masked, the dead row re-seeded in place at
the grow, and hashes each row under its original pod id.  Each rank runs
the resize placed (``elastic_shrink`` / ``elastic_grow``) and reports
its rows' digests, the groups' global ranks, and every collective of
each step: a round gathers its specs at the current pod count, the
shrink (its flush commit included) nothing, the grow one broadcast of
the unstacked tree, and a rank outside the group nothing.
With the elastic cases each rank also runs ``launch.elastic``'s drop
and rejoin proofs placed, checking its own rows.  ``regroup_audit``
builds a pod group over given global ranks on spawned ranks and
regroups it, to check each tier's members by global rank.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.analysis.collectives import count_collectives, records, tier
from repro_torch.config import HermesConfig, OptimizerConfig
from repro_torch.core.gup import gup_gate
from repro_torch.dist import hermes_sync as hs
from repro_torch.dist import wire
from repro_torch.dist.wire import all_gather_rows
from repro_torch.kernels import build
from repro_torch.launch import elastic as el
from repro_torch.launch.mesh import (
    PodGroups, flatten_cluster_groups, make_pod_groups, rank_layout,
    regroup_groups,
)
from repro_torch.launch.spawn import spawn_ranks
from repro_torch.utils.trees import tree_flatten, tree_map

CASES = ("flat", "flat_async", "cluster", "cluster_async", "closed")
ELASTIC = ("drop", "rejoin", "cluster_resize")
TOY = {"a": (8, 16), "b": (16,), "c": (3, 512), "e": ()}
#: the reference's round-audit tree: one blocked leaf, one short tail
ROUND = {"w": (4, 512), "b": (7,)}
TOYS = {"toy": TOY, "round": ROUND}
META = torch.device("meta")


def _digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes, with its dtype and shape."""
    a = t.detach().contiguous().cpu()
    h = hashlib.sha256(f"{a.dtype}{tuple(a.shape)}".encode())
    h.update(a.reshape(-1).view(torch.uint8).numpy().data)
    return h.hexdigest()


def _w_global(job: Dict[str, Any], dev: torch.device, scalars=True):
    """The global model of ``job``'s preset: a toy tree (``toy`` without
    ``scalars`` leaves out its scalar leaf: a two-tier commit masks
    cluster rows, and a stacked scalar's re-encoded partial has none, the
    reference asserts so), a trainer preset, or with ``layers`` an
    architecture's published config cut to that many layers, in
    ``dtype``.  On ``meta``: shapes and dtypes alone."""
    preset, seed = job["preset"], job["seed"]
    dtype = getattr(torch, job.get("dtype", "float32"))
    if preset in TOYS:
        gen = torch.Generator().manual_seed(seed)
        return {k: torch.randn(s, generator=gen).to(device=dev, dtype=dtype)
                for k, s in TOYS[preset].items() if scalars or s}
    from repro_torch.models.lm import init_lm
    return init_lm(_config(job), seed, dev,
                   draw_on=None if dev.type == "meta" else dev, dtype=dtype)


def _config(job: Dict[str, Any]):
    """The model config of a non-toy preset."""
    if job.get("layers"):
        import dataclasses
        from repro_torch.configs import get_config
        return dataclasses.replace(get_config(job["preset"]),
                                   num_layers=job["layers"])
    from repro_torch.launch.train import _preset
    return _preset(job["preset"])


def _scalars(case: str, fmt: str) -> bool:
    return case != "cluster_async" or fmt in ("none", "fp16")


def _inputs(job: Dict[str, Any], dev: torch.device, rows: slice,
            scalars: bool = True):
    """The rounds' inputs, made from the seed: ``(w_global, pod rows,
    error rows or None, the open gate state's rows)``."""
    seed, n = job["seed"], job["n_pods"]
    w = _w_global(job, dev, scalars)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    pods = tree_map(lambda g: g[None] + 1e-3 * torch.randn(
        (n,) + tuple(g.shape), generator=gen, device=dev,
        dtype=g.dtype)[rows], w)
    err = None
    if job["error_scale"]:
        err = tree_map(lambda g: job["error_scale"] * torch.randn(
            (n,) + tuple(g.shape), generator=gen, device=dev)[rows], w)
    cfg = HermesConfig()
    gup = hs.hermes_pod_state(cfg, n, dev)
    for level in (3.0, 3.2):  # a loss history the open losses beat
        _, gup = gup_gate(gup, torch.full((n,), level, device=dev), cfg)
    return w, pods, err, {k: v[rows] for k, v in gup.items()}


def _cfg(fmt: str, n_clusters: int) -> HermesConfig:
    return HermesConfig(compression=fmt, n_clusters=n_clusters,
                        error_feedback=fmt in ("int8", "int4"))


def _run_case(case, fmt, job, dev, rows, groups=None, log=None):
    """One case; returns ``(outputs, merged flags, collectives by
    phase)``: outputs ``{"w_global", "pods", "error"}`` (row trees); the
    collectives named (:func:`_named`) and, under ``"records"``, as the
    collective-placement rule's records."""
    n, C = job["n_pods"], job["n_clusters"]
    w, pods, err, gup = _inputs(job, dev, rows, _scalars(case, fmt))
    level = 4.0 if case == "closed" else 2.0
    losses = (level + 0.05 * torch.arange(n, device=dev,
                                          dtype=torch.float32))[rows]
    L = torch.tensor(3.4, device=dev)
    noise = wire.GeneratorNoise(job["seed"] + 2, dev)
    kw = dict(error=err, round_step=1, noise=noise, groups=groups)
    phases: Dict[str, List] = {}
    merged = []

    @contextlib.contextmanager
    def phase(name):
        start = len(log) if log is not None else 0
        yield
        if log is not None:
            phases[name] = _named(log[start:], groups)
            phases.setdefault("records", {})[name] = records(log[start:],
                                                             groups)

    outs = {}
    if case in ("flat", "cluster", "closed"):
        rounds = [("flat", hs.hermes_round, _cfg(fmt, 1)),
                  ("cluster", hs.hermes_cluster_round, _cfg(fmt, C))]
        for name, fn, cfg in rounds:
            if case != "closed" and name != case:
                continue
            with phase(f"{name}_round"):
                out = fn(pods, gup, losses, w, L, cfg, **kw)
            merged.append(out["merged"])
            outs = out
    else:
        flat = case == "flat_async"
        cfg = _cfg(fmt, 1 if flat else C)
        dispatch = hs.hermes_dispatch if flat else hs.hermes_cluster_dispatch
        commit = hs.hermes_commit if flat else hs.hermes_cluster_commit
        with phase("dispatch"):
            dp = dispatch(pods, gup, losses, w, L, cfg, **kw)
        merged.append(hs.pending_merges(dp["pending"]))
        with phase("commit"):
            cm = commit(pods, dp["pending"], w, cfg=cfg, groups=groups)
        outs = {"w_global": cm["w_global"], "pod_params": cm["pod_params"],
                "error": dp["error"]}
    return ({"w_global": outs["w_global"], "pods": outs["pod_params"],
             "error": outs["error"]}, merged, phases)


def _hashes(outs, n_rows: int, first: int = 0,
            ids: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """Digests: every ``w_global`` leaf; per pod row (global index, or
    ``ids[i]`` for row ``i``) every leaf of that row of the pods, the
    error and, where ``outs`` has it, the gate state.  The tensors are
    copied to the host one at a time and hashed on a pool of threads
    (``hashlib`` releases the GIL)."""
    ids = list(range(first, first + n_rows)) if ids is None else list(ids)
    names, tensors = [], []
    for i, x in enumerate(tree_flatten(outs["w_global"])[0]):
        names.append(("w_global", i))
        tensors.append(x)
    for key in ("pods", "error", "gup"):
        if outs.get(key) is None:
            continue
        for j, x in enumerate(tree_flatten(outs[key])[0]):
            for i in range(n_rows):
                names.append((f"{key}{ids[i]}", j))
                tensors.append(x[i])
    with ThreadPoolExecutor(max_workers=max(1, os.cpu_count() or 1)) as ex:
        digests = list(ex.map(_digest, tensors))
    out: Dict[str, List[str]] = {}
    for (key, _), d in zip(names, digests):
        out.setdefault(key, []).append(d)
    return out


@contextlib.contextmanager
def _determinism(on: bool):
    """Deterministic algorithms for the run (``warn_only``: cuBLAS's own
    check would raise without ``CUBLAS_WORKSPACE_CONFIG``)."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before, warn_only=True)


def _train(job, dev, groups=None):
    from repro_torch.launch.train import _preset, train_hermes
    t = job["train"]
    hcfg = HermesConfig(alpha=-0.8, lam=2, compression=t["compression"],
                        n_clusters=job["n_clusters"],
                        async_rounds=t["async_rounds"])
    with _determinism(job["deterministic"]):
        out = train_hermes(
            _preset(job["preset"]), steps=t["steps"], batch=t["batch"],
            seq=t["seq"], pods=job["n_pods"],
            opt_cfg=OptimizerConfig(name="adamw", lr=t["lr"]), hcfg=hcfg,
            log_every=10 ** 6, seed=job["seed"], device=dev, groups=groups)
    return {k: out[k] for k in ("history", "merges", "rounds",
                                "global_loss", "pod_losses", "dispatched",
                                "committed", "drained", "ms_per_step",
                                "ms_per_round")}


def _launches() -> Dict[str, int]:
    return {k: v for k, v in build.LAUNCHES.items() if v}


def _named(entries, groups: Optional[PodGroups]) -> List:
    """Collectives logged by ``analysis.collectives.count_collectives``
    as ``(tier, dtype, per-rank dims, bytes)``, the tier read against
    ``groups`` (suffixed with the kind, ``/broadcast``, for any but a
    gather)."""
    return [(tier(g, groups) + ("" if kind == "all_gather_into_tensor"
                                else f"/{kind}"),
             op["dtype"], tuple(op["dims"]), op["bytes"])
            for g, kind, op in entries]


def _rank_main(rank: int, world: int, job: Dict[str, Any]
               ) -> Dict[str, Any]:
    """One rank (``launch.spawn.spawn_ranks``): the cases placed,
    compared with the parent's digests."""
    torch.set_num_threads(job["threads"])
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    groups = make_pod_groups(job["n_pods"], job["n_clusters"])
    log: List = []
    count_collectives(log)
    report: Dict[str, Any] = {"rank": rank, "cases": {}}
    rows, n_rows = groups.rows, groups.rows_per_rank
    for fmt in job["formats"]:
        for case in job["cases"]:
            t0 = time.perf_counter()
            build.reset_launches()
            outs, merged, phases = _run_case(case, fmt, job, dev, rows,
                                             groups, log)
            got = _hashes(outs, n_rows, rows.start)
            want = job["digests"][f"{fmt}/{case}"]
            report["cases"][f"{fmt}/{case}"] = {
                "equal": {k: v == want[k] for k, v in got.items()},
                "merged": merged,
                "records": phases.pop("records", {}), "phases": phases,
                "launches": _launches(),
                "seconds": time.perf_counter() - t0}
            del outs
    report["elastic"], report["proofs"] = {}, {}
    for fmt in job["elastic_formats"]:
        for case in job["elastic"]:
            t0 = time.perf_counter()
            build.reset_launches()
            got = _run_elastic(case, fmt, job, dev, groups, log)
            got.update(launches=_launches(),
                       seconds=time.perf_counter() - t0)
            report["elastic"][f"{fmt}/{case}"] = got
        if job["elastic"]:
            report["proofs"][fmt] = _proofs(fmt, job, dev)
    if job.get("train"):
        build.reset_launches()
        report["train"] = _train(job, dev, groups)
        report["train"]["launches"] = _launches()
    report["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else None)
    return report


def _proofs(fmt: str, job: Dict[str, Any], dev: torch.device
            ) -> Dict[str, Any]:
    """``launch.elastic``'s drop (pod 1) and rejoin (the last pod) proofs
    placed over one pod a rank: each rank runs both paths on its own rows
    and checks them (a failing check fails the rank)."""
    n, cfg = job["n_pods"], _elastic_cfg(fmt)
    kw = dict(n_pods=n, cfg=cfg, device=dev, pod_noise=job["pod_noise"])
    return {"drop": el.drop_pod_equivalence(
                drop=1, groups=make_pod_groups(n), **kw),
            "rejoin": el.rejoin_pod_equivalence(
                groups=make_pod_groups(n), **kw)}


def _elastic_plan(case: str, n_pods: int, n_clusters: int):
    """``(dead pod, steps)`` of an elastic case: ``("round", r, tiers)``
    (``hermes_round``, or ``hermes_cluster_round`` over ``tiers``
    clusters), ``("dispatch", r, 1)`` (``hermes_dispatch``, left pending),
    ``("death",)``, ``("shrink",)`` and ``("grow",)``.  Round ``r`` takes
    ``launch.elastic._demo_losses``'s row ``r``: pod ``i``'s loss drops
    when ``r % 7 == i + 3``, so pod 1 pushes in the dispatch that dies
    with it, and every stretch merges."""
    def rounds(rs, tiers=1):
        return [("round", r, tiers) for r in rs]

    if case == "drop":
        return 1, rounds(range(4)) + [("dispatch", 4, 1), ("death",),
                                      ("shrink",)] + rounds(range(5, 8))
    if case == "rejoin":
        return n_pods - 1, rounds(range(3)) + [("death",)] + rounds([3]) + \
            [("shrink",)] + rounds([4, 5]) + [("grow",)] + rounds(range(6, 11))
    if case == "cluster_resize":
        return n_pods - 1, rounds(range(4), n_clusters) + [("death",)] + \
            rounds([4], n_clusters) + [("shrink",)] + rounds([5, 6]) + \
            [("grow",)] + rounds(range(7, 11), n_clusters)
    raise ValueError(f"unknown elastic case {case!r} (want {ELASTIC})")


def _step_name(step) -> str:
    return f"r{step[1]}" if step[0] in ("round", "dispatch") else step[0]


def _elastic_cfg(fmt: str) -> HermesConfig:
    return HermesConfig(alpha=-0.5, beta=0.1, lam=2, window=4,
                        compression=fmt, min_live_pods=1,
                        rejoin_cost_rounds=0.0)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tiers(groups: PodGroups) -> Dict[str, List[int]]:
    """The global ranks of each of this rank's tiers."""
    out = {"pod": list(groups.members)}
    if groups.n_clusters > 1:
        out["intra"] = dist.get_process_group_ranks(groups.intra)
        out["cluster"] = dist.get_process_group_ranks(groups.cross)
    return out


def _run_elastic(case, fmt, job, dev, groups=None, log=None):
    """One elastic case.  ``groups=None``: the never-resized oracle, every
    row kept, the dead stretch live-masked, the pending flushed under the
    mask at the shrink and the dead row re-seeded at the grow.  Placed:
    the resize, ``elastic_shrink`` / ``elastic_grow`` over the rank's
    groups, each step's collectives named against the groups it ends
    with.  Returns ``{"digests", "rows", "merged", "phases", "members",
    "tiers", "ms"}`` (each step's wall ms), the rows under their original
    pod ids."""
    n, C = job["n_pods"], job["n_clusters"]
    cfg = _elastic_cfg(fmt)
    dead, steps = _elastic_plan(case, n, C)
    rounds = el._Rounds(cfg, n, dev, job.get("pod_noise"))
    oracle = groups is None
    w = _w_global(job, dev)
    gen = torch.Generator(device=dev).manual_seed(job["seed"] + 1)
    pods = tree_map(lambda g: g[None] + 1e-3 * torch.randn(
        (n,) + tuple(g.shape), generator=gen, device=dev), w)
    state = {"pod_params": pods, "gup": hs.hermes_pod_state(cfg, n, dev),
             "error": None, "w_global": w, "pending": None}
    report: Dict[str, Any] = {"merged": {}, "phases": {}, "members": {},
                              "tiers": {}, "ms": {}}
    if not oracle:
        if case != "cluster_resize":
            groups = flatten_cluster_groups(groups)
        report["tiers"]["start"] = _tiers(groups)
        state["pod_params"] = tree_map(lambda x: x[groups.rows], pods)
        state["gup"] = tree_map(lambda x: x[groups.rows], state["gup"])
        if case == "cluster_resize":
            # the failure domain is cluster-local: a drop in cluster 0 with
            # a shrink of cluster 1 is refused, before any collective
            try:
                el.elastic_shrink(state, [0, 2], groups, cfg=cfg, cluster=1)
                report["cross_cluster_refused"] = False
            except ValueError:
                report["cross_cluster_refused"] = True
    del pods
    ids = list(range(n))  # the original pod of each stacked row
    alive = np.ones((n,), bool)
    template = layout = None
    for step in steps:
        kind, name = step[0], _step_name(step)
        start = len(log) if log is not None else 0
        _sync(dev)
        t0 = time.perf_counter()
        if kind == "round" and state is not None:
            st = rounds(el._from_state(state), 1, step[1], ids,
                        live=alive[ids], groups=groups,
                        two_tier={"n_clusters": step[2]} if step[2] > 1
                        else None)
            state = {**state, **el._as_state(st)}
            report["merged"][name] = rounds.merged[-1]
        elif kind == "dispatch" and state is not None:
            losses, live, noise = rounds.inputs(step[1], ids, alive[ids],
                                                groups)
            out = hs.hermes_dispatch(
                state["pod_params"], state["gup"], losses, state["w_global"],
                rounds.L, cfg, live=live, error=state["error"],
                round_step=step[1], noise=noise, groups=groups)
            state = {**state, "gup": out["gup"], "error": out["error"],
                     "pending": out["pending"]}
            report["merged"][name] = hs.pending_merges(out["pending"])
        elif kind == "death":
            alive[dead] = False
            row = ids.index(dead)
            if state is not None and (oracle or groups.rows.start <= row
                                      < groups.rows.stop):
                state = {**state, "pod_params": el._poison(
                    state["pod_params"], row - (0 if oracle else
                                                groups.rows.start))}
        elif kind == "shrink" and oracle:
            state = el.flush_pending(state, cfg=cfg, live=alive)
        elif kind == "shrink":
            keep = [i for i, p in enumerate(ids) if p != dead]
            cl = {"cluster": C - 1} if case == "cluster_resize" else {}
            template, layout = state, el.survivor_layout(groups, keep, **cl)
            state, groups = el.elastic_shrink(state, keep, groups, cfg=cfg,
                                              **cl)
            ids = [ids[i] for i in keep]
            report["members"][name] = list(layout[0])
        elif kind == "grow" and oracle:
            st = el._reseed(el._from_state(state), dead,
                            hs.hermes_pod_state(cfg, 1, dev))
            state = {**el._as_state(st), "pending": None}
            alive[dead] = True
        elif kind == "grow":
            newcomer = state is None
            state, groups = el.elastic_grow(
                template if newcomer else state, None if newcomer else groups,
                cfg=cfg, layout=layout if newcomer else None,
                n_clusters=C if case == "cluster_resize" else None)
            ids.append(dead)
            alive[dead] = True
            report["members"][name] = list(groups.members)
            report["tiers"]["grown"] = _tiers(groups)
        _sync(dev)
        report["ms"][name] = 1e3 * (time.perf_counter() - t0)
        if log is not None:
            report["phases"][name] = _named(log[start:], groups)
    if state is None:
        report.update(digests={}, rows=[])
        return report
    rows = range(n) if oracle else range(groups.rows.start, groups.rows.stop)
    outs = {"w_global": state["w_global"], "pods": state["pod_params"],
            "error": state["error"], "gup": state["gup"]}
    report["rows"] = [ids[i] for i in rows]
    report["digests"] = _hashes(outs, len(rows), ids=report["rows"])
    return report


def expected_elastic(tree, fmt: str, case: str, n_pods: int,
                     n_clusters: int, merged: Dict[str, bool]
                     ) -> List[Dict[str, List]]:
    """Each rank's collectives, step by step, in an elastic case (one pod
    a rank): a round gathers the gate exchange and, if it merged (the
    oracle's ``merged``), the specs of :func:`expected_collectives` at the
    CURRENT pod count; a dispatch the same; the death and the shrink
    nothing, its flush commit included; the grow one broadcast of the
    unstacked tree's bytes on every rank of the regrown group; a rank
    outside the group nothing."""
    dead, steps = _elastic_plan(case, n_pods, n_clusters)
    nbytes = sum(x.numel() * x.element_size() for x in tree_flatten(tree)[0])
    ctl = [("pod",) + wire.control_operand_spec(1)]
    out = []
    for rank in range(n_pods):
        n_cur, inside, phases = n_pods, True, {}
        for step in steps:
            kind, name = step[0], _step_name(step)
            got: List = []
            if kind in ("round", "dispatch") and inside:
                got = ctl
                if merged[name]:
                    tiers = step[2]
                    key = "cluster" if tiers > 1 else "flat"
                    got = expected_collectives(tree, fmt, key, n_cur, tiers,
                                               n_cur)[f"{key}_round"]
            elif kind == "shrink":
                n_cur -= 1
                inside = rank != dead
            elif kind == "grow":
                n_cur += 1
                inside = True
                got = [("pod/broadcast", "uint8", (nbytes,), nbytes)]
            phases[name] = got
        out.append(phases)
    return json.loads(json.dumps(out))


def expected_collectives(tree, fmt: str, case: str, n_pods: int,
                         n_clusters: int, world: int
                         ) -> Dict[str, List]:
    """Each phase's gathers that ``dist.wire``'s specs say a rank issues:
    the gate exchange, then the flat ship (``wire_operand_specs``), or the
    fast tier (the same operands; a leaf encoded whole gathers its rows
    over the pod group, the rest over the intra-cluster group, none on a
    group of one) and the slow tier (``cluster_wire_operand_specs``).  A
    commit gathers nothing; a closed round only the gate exchange."""
    rows = n_pods // world
    ctl = [("pod",) + wire.control_operand_spec(rows)]
    flat = [("pod",) + s for s in wire.wire_operand_specs(
        tree, fmt, n_pods, rows=rows)]
    leaves = tree_flatten(tree)[0]
    n_whole = sum(not wire.row_local(fmt, x.shape, n_pods, n_clusters)
                  for x in leaves)
    fast = wire.wire_operand_specs(tree, fmt, n_pods, rows=rows,
                                   n_clusters=n_clusters)
    intra = len(rank_layout(world, n_pods, n_clusters)[0][0]) > 1
    tiered = [("pod",) + s for s in fast[:n_whole]] + \
        ([("intra",) + s for s in fast[n_whole:]] if intra else []) + \
        [("cluster",) + s for s in wire.cluster_wire_operand_specs(
            tree, fmt, n_clusters, n_pods=n_pods)]
    if case == "closed":
        return {"flat_round": ctl, "cluster_round": ctl}
    if case == "flat":
        return {"flat_round": ctl + flat}
    if case == "cluster":
        return {"cluster_round": ctl + tiered}
    return {"dispatch": ctl + (flat if case == "flat_async" else tiered),
            "commit": []}


def audit(preset: str = "toy", *, ranks: int = 4, n_pods: int = 4,
          n_clusters: int = 2, formats: Sequence[str] = wire.available_formats(),
          cases: Sequence[str] = CASES, train: Optional[Dict] = None,
          elastic: Sequence[str] = (), pod_noise=None,
          device="cuda", seed: int = 0, deterministic: bool = True,
          timeout: float = 600.0, workdir: Optional[str] = None,
          layers: int = 0, dtype: str = "float32") -> Dict[str, Any]:
    """Run the cases unplaced here, then placed on ``ranks`` spawned
    processes; returns ``{"cases": {"fmt/case": {"equal", "merged",
    "collectives", "records", "expected"}}, "elastic": {"fmt/case":
    {...}}, "train": {...}, "proofs": {fmt: [each rank's {"drop",
    "rejoin"}]}, "peak_bytes": [each rank's], "seconds"}`` with every
    rank's report merged.  ``preset`` is ``toy``, ``round``, a trainer
    preset, or with ``layers`` an architecture cut to that many layers;
    the models are in ``dtype``.  The elastic
    cases need one pod a rank; ``pod_noise(ids)``, a picklable factory,
    gives their rounds' int4 noise for the stacked rows of the original
    pods ``ids``.  Without it they skip int4, whose default noise is not
    resize-invariant (the reference pins ``none``, ``fp16`` and ``int8``).
    A rank that fails fails the audit (raises, with its traceback)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rank_layout(ranks, n_pods, n_clusters)
    if elastic and ranks != n_pods:
        raise ValueError("the elastic cases place one pod a rank")
    job = {"preset": preset, "layers": layers, "dtype": dtype,
           "n_pods": n_pods, "n_clusters": n_clusters,
           "formats": list(formats), "cases": list(cases), "seed": seed,
           "elastic": list(elastic), "pod_noise": pod_noise,
           "elastic_formats": [f for f in formats
                               if f != "int4" or pod_noise is not None],
           "elastic_oracle": {},
           "device": str(dev),
           # the ranks share the host's cores; the unplaced run uses as
           # many threads as one rank
           "threads": max(1, torch.get_num_threads() // ranks),
           "error_scale": 1e-4 if preset in TOYS else 0.0,
           "deterministic": deterministic, "train": train, "digests": {}}
    every = slice(0, n_pods)
    threads = torch.get_num_threads()
    torch.set_num_threads(job["threads"])
    try:
        for fmt in formats:
            for case in cases:
                outs, merged, _ = _run_case(case, fmt, job, dev, every)
                job["digests"][f"{fmt}/{case}"] = dict(
                    _hashes(outs, n_pods), merged=merged)
                del outs
            for case in elastic if fmt in job["elastic_formats"] else ():
                got = _run_elastic(case, fmt, job, dev)
                job["elastic_oracle"][f"{fmt}/{case}"] = {
                    "digests": got["digests"], "merged": got["merged"]}
        unplaced_train = None
        if train:
            build.reset_launches()
            unplaced_train = _train(job, dev)
            unplaced_train["launches"] = _launches()
    finally:
        torch.set_num_threads(threads)
    trees = {sc: _w_global(job, META, sc) for sc in (True, False)}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    unplaced_s = time.perf_counter() - t0
    reports = spawn_ranks(ranks, job, _rank_main, timeout=timeout,
                          workdir=workdir)
    out: Dict[str, Any] = {"cases": {}, "unplaced_s": unplaced_s,
                           "seconds": time.perf_counter() - t0,
                           "peak_bytes": [r["peak_bytes"] for r in reports]}
    for key in job["digests"]:
        fmt, case = key.split("/")
        per = [r["cases"][key] for r in reports]
        out["cases"][key] = {
            "equal": all(all(p["equal"].values()) for p in per),
            "merged": [p["merged"] for p in per],
            "unplaced_merged": job["digests"][key]["merged"],
            "launches": [p["launches"] for p in per],
            "collectives": [p["phases"] for p in per],
            "records": [p["records"] for p in per],
            # as the ranks' reports read back (JSON lists)
            "expected": json.loads(json.dumps(expected_collectives(
                trees[_scalars(case, fmt)], fmt, case, n_pods, n_clusters,
                ranks))),
            "seconds": max(p["seconds"] for p in per)}
    out["elastic"] = {}
    for key, want in job["elastic_oracle"].items():
        fmt, case = key.split("/")
        per = [r["elastic"][key] for r in reports]
        equal = [all(d == want["digests"][k] for k, d in p["digests"].items())
                 for p in per]
        out["elastic"][key] = {
            "equal": all(equal), "equal_per_rank": equal,
            "rows": [p["rows"] for p in per],
            "merged": [p["merged"] for p in per],
            "unplaced_merged": want["merged"],
            "collectives": [p["phases"] for p in per],
            "expected": expected_elastic(trees[True], fmt, case, n_pods,
                                         n_clusters, want["merged"]),
            "members": [p["members"] for p in per],
            "tiers": [p["tiers"] for p in per],
            "cross_cluster_refused": [p.get("cross_cluster_refused")
                                      for p in per],
            "launches": [p["launches"] for p in per],
            "ms": [p["ms"] for p in per],
            "seconds": max(p["seconds"] for p in per)}
    out["proofs"] = {fmt: [r["proofs"][fmt] for r in reports]
                     for fmt in (job["elastic_formats"] if elastic else ())}
    if train:
        out["train"] = {"unplaced": json.loads(json.dumps(unplaced_train)),
                        "placed": [r["train"] for r in reports]}
    return out


def _regroup_main(rank: int, world: int, job: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """One rank of :func:`regroup_audit`."""
    members, n_pods = tuple(job["members"]), job["n_pods"]
    pod = dist.new_group(list(members))
    groups = None
    if rank in members:
        groups = PodGroups(n_pods=n_pods,
                           rank=dist.get_group_rank(pod, rank),
                           size=len(members), pod=pod, members=members)
    got = regroup_groups(groups, job["n_clusters"],
                         layout=(members, n_pods))
    report: Dict[str, Any] = {"rank": rank, "member": got is not None}
    if got is not None:
        me = torch.tensor([float(rank)])
        met = {tier: all_gather_rows(me, *got.group(tier)).int().tolist()
               for tier in ("pod", "intra", "cluster")}
        report.update(group_rank=got.rank, cluster=got.cluster,
                      rows=[got.rows.start, got.rows.stop],
                      tiers=_tiers(got), met=met)
    return report


def regroup_audit(members: Sequence[int], world: int, n_clusters: int, *,
                  n_pods: Optional[int] = None, timeout: float = 120.0,
                  workdir: Optional[str] = None) -> List[Dict[str, Any]]:
    """Build a pod group over the global ranks ``members`` of a ``world``
    of spawned gloo ranks (one pod a member by default), regroup it into
    ``n_clusters`` tiers and report, per rank: whether it is a member, its
    group rank, cluster and rows, each tier's global ranks, and the ranks
    that met in one gather over each tier."""
    job = {"members": list(members), "n_clusters": n_clusters,
           "n_pods": len(members) if n_pods is None else n_pods}
    return spawn_ranks(world, job, _regroup_main, timeout=timeout,
                       workdir=workdir)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="toy")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--pods", type=int, default=4)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--formats", nargs="+",
                    default=list(wire.available_formats()))
    ap.add_argument("--train-steps", type=int, default=0)
    ap.add_argument("--elastic", action="store_true",
                    help="also the elastic cases (needs --ranks == --pods; "
                         "not int4, whose noise is not resize-invariant)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train = None if not args.train_steps else {
        "steps": args.train_steps, "compression": "int4",
        "async_rounds": False, "batch": 8 if args.preset == "lm100m" else 4,
        "seq": 128 if args.preset == "lm100m" else 32,
        "lr": 3e-4 if args.preset == "lm100m" else 3e-3}
    out = audit(args.preset, ranks=args.ranks, n_pods=args.pods,
                n_clusters=args.clusters, formats=args.formats, train=train,
                elastic=ELASTIC if args.elastic else (), device=args.device)
    bad = [k for k, v in out["cases"].items() if not v["equal"]
           or any(c != v["expected"] for c in v["collectives"])]
    bad += [k for k, v in out["elastic"].items() if not v["equal"]
            or v["collectives"] != v["expected"]]
    print(json.dumps({"cases": len(out["cases"]) + len(out["elastic"]),
                      "differ": bad,
                      "seconds": out["seconds"]}))
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
