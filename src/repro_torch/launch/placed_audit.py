"""Placed Hermes rounds against unplaced ones, on one machine.

    python -m repro_torch.launch.placed_audit --preset lm100m --ranks 4 \
        --pods 4 --clusters 2 --formats int4 int8 --train-steps 6
    python -m repro_torch.launch.placed_audit --preset toy --device cpu

The parent process runs every case unplaced, all pods in one process,
keeps a SHA-256 of each output (``w_global``, every pod row, every error
row), frees what it holds, and spawns one process per rank: gloo over a
``FileStore``, every rank's tensors on the parent's device (one card can
host them all: gloo gathers CUDA tensors).  Each rank rebuilds the same
inputs from the seed, keeps its own pod rows, runs the same cases placed
over ``launch.mesh.make_pod_groups`` and reports whether its outputs hash
as the parent's, the host's ``merged`` flag of each round, and every
``all_gather_into_tensor`` it issued: the tier, dtype, per-rank dims and
bytes, to be held against ``dist.wire``'s specs.

Cases, per wire format, gates forced open by a loss history the round's
losses beat: ``flat`` (``hermes_round``), ``flat_async``
(``hermes_dispatch`` + ``hermes_commit``), ``cluster`` and
``cluster_async`` (the two-tier twins), and ``closed`` (a flat and a
two-tier round whose gates stay shut).  ``train`` runs
``train_hermes`` unplaced, then placed.  The ``toy`` preset is a small
tree with a scalar leaf, which a placed round encodes whole.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import resolve_device
from repro_torch.config import HermesConfig, OptimizerConfig
from repro_torch.core.gup import gup_gate
from repro_torch.dist import hermes_sync as hs
from repro_torch.dist import wire
from repro_torch.kernels import build
from repro_torch.launch.mesh import make_pod_groups, rank_layout
from repro_torch.utils.trees import tree_flatten, tree_map

CASES = ("flat", "flat_async", "cluster", "cluster_async", "closed")
TOY = {"a": (8, 16), "b": (16,), "c": (3, 512), "e": ()}


def _digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes, with its dtype and shape."""
    a = t.detach().contiguous().cpu()
    h = hashlib.sha256(f"{a.dtype}{tuple(a.shape)}".encode())
    h.update(a.reshape(-1).view(torch.uint8).numpy().data)
    return h.hexdigest()


def _w_global(preset: str, seed: int, dev: torch.device, scalars=True):
    """The global model.  ``toy`` without ``scalars`` leaves out its
    scalar leaf: a two-tier commit masks cluster rows, and a stacked
    scalar's re-encoded partial has none (the reference asserts so)."""
    if preset == "toy":
        gen = torch.Generator().manual_seed(seed)
        return {k: torch.randn(s, generator=gen).to(dev)
                for k, s in TOY.items() if scalars or s}
    from repro_torch.launch.train import _preset
    from repro_torch.models.lm import init_lm
    return init_lm(_preset(preset), seed, dev, draw_on=dev)


def _scalars(case: str, fmt: str) -> bool:
    return case != "cluster_async" or fmt in ("none", "fp16")


def _inputs(job: Dict[str, Any], dev: torch.device, rows: slice,
            scalars: bool = True):
    """The rounds' inputs, made from the seed: ``(w_global, pod rows,
    error rows or None, the open gate state's rows)``."""
    seed, n = job["seed"], job["n_pods"]
    w = _w_global(job["preset"], seed, dev, scalars)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    pods = tree_map(lambda g: g[None] + 1e-3 * torch.randn(
        (n,) + tuple(g.shape), generator=gen, device=dev)[rows], w)
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
    phase)``: outputs ``{"w_global", "pods", "error"}`` (row trees)."""
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
            phases[name] = log[start:]

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


def _hashes(outs, n_rows: int, first: int = 0) -> Dict[str, Any]:
    """Digests: every ``w_global`` leaf; per pod row (global index) every
    leaf of that row of the pods and of the error.  The tensors are copied
    to the host one at a time and hashed on a pool of threads (``hashlib``
    releases the GIL)."""
    names, tensors = [], []
    for i, x in enumerate(tree_flatten(outs["w_global"])[0]):
        names.append(("w_global", i))
        tensors.append(x)
    for key in ("pods", "error"):
        if outs[key] is None:
            continue
        for j, x in enumerate(tree_flatten(outs[key])[0]):
            for i in range(n_rows):
                names.append((f"{key}{first + i}", j))
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


def _counting(log: List, groups):
    """Record every ``all_gather_into_tensor`` this rank issues: ``(tier,
    dtype, per-rank dims, bytes)``."""
    real = dist.all_gather_into_tensor
    tiers = {id(groups.pod): "pod", id(None): "pod"}
    if groups.n_clusters > 1:
        tiers[id(groups.intra)] = "intra"
        tiers[id(groups.cross)] = "cluster"

    def counted(out, inp, group=None, async_op=False):
        log.append((tiers[id(group)], str(inp.dtype).removeprefix("torch."),
                    tuple(inp.shape), inp.numel() * inp.element_size()))
        return real(out, inp, group=group, async_op=async_op)

    dist.all_gather_into_tensor = counted


def _rank_main(rank: int, world: int, store: str, job: Dict[str, Any],
               out_dir: str) -> None:
    """One rank: the cases placed, compared with the parent's digests."""
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        torch.set_num_threads(job["threads"])
        dev = torch.device(job["device"])
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        groups = make_pod_groups(job["n_pods"], job["n_clusters"])
        log: List = []
        _counting(log, groups)
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
                    "merged": merged, "phases": phases,
                    "launches": _launches(),
                    "seconds": time.perf_counter() - t0}
                del outs
        if job.get("train"):
            build.reset_launches()
            report["train"] = _train(job, dev, groups)
            report["train"]["launches"] = _launches()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


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
          device="cuda", seed: int = 0, deterministic: bool = True,
          timeout: float = 600.0, workdir: Optional[str] = None
          ) -> Dict[str, Any]:
    """Run the cases unplaced here, then placed on ``ranks`` spawned
    processes; returns ``{"cases": {"fmt/case": {"equal", "merged",
    "collectives", "expected"}}, "train": {...}, "seconds"}`` with every
    rank's report merged.  A rank that fails fails the audit (raises)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rank_layout(ranks, n_pods, n_clusters)
    job = {"preset": preset, "n_pods": n_pods, "n_clusters": n_clusters,
           "formats": list(formats), "cases": list(cases), "seed": seed,
           "device": str(dev),
           # the ranks share the host's cores; the unplaced run uses as
           # many threads as one rank
           "threads": max(1, torch.get_num_threads() // ranks),
           "error_scale": 1e-4 if preset == "toy" else 0.0,
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
        unplaced_train = None
        if train:
            build.reset_launches()
            unplaced_train = _train(job, dev)
            unplaced_train["launches"] = _launches()
    finally:
        torch.set_num_threads(threads)
    trees = {sc: tree_map(lambda g: torch.empty(g.shape, dtype=g.dtype,
                                                device="meta"),
                          _w_global(preset, seed, dev, sc))
             for sc in (True, False)}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    unplaced_s = time.perf_counter() - t0
    reports = _spawn(ranks, job, timeout, workdir)
    out: Dict[str, Any] = {"cases": {}, "unplaced_s": unplaced_s,
                           "seconds": time.perf_counter() - t0}
    for key in job["digests"]:
        fmt, case = key.split("/")
        per = [r["cases"][key] for r in reports]
        out["cases"][key] = {
            "equal": all(all(p["equal"].values()) for p in per),
            "merged": [p["merged"] for p in per],
            "unplaced_merged": job["digests"][key]["merged"],
            "launches": [p["launches"] for p in per],
            "collectives": [p["phases"] for p in per],
            # as the ranks' reports read back (JSON lists)
            "expected": json.loads(json.dumps(expected_collectives(
                trees[_scalars(case, fmt)], fmt, case, n_pods, n_clusters,
                ranks))),
            "seconds": max(p["seconds"] for p in per)}
    if train:
        out["train"] = {"unplaced": json.loads(json.dumps(unplaced_train)),
                        "placed": [r["train"] for r in reports]}
    return out


def _spawn(ranks: int, job, timeout: float, workdir: Optional[str]):
    """Start every rank, wait for all, and read their reports; a rank that
    exits nonzero or runs past ``timeout`` fails the audit."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, ranks, store, job, tmp))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if late or any(codes):
            raise RuntimeError(f"placed ranks failed: exit codes {codes}, "
                               f"past the {timeout:.0f} s limit: {late}")
        reports = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    return reports


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="toy")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--pods", type=int, default=4)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--formats", nargs="+",
                    default=list(wire.available_formats()))
    ap.add_argument("--train-steps", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train = None if not args.train_steps else {
        "steps": args.train_steps, "compression": "int4",
        "async_rounds": False, "batch": 8 if args.preset == "lm100m" else 4,
        "seq": 128 if args.preset == "lm100m" else 32,
        "lr": 3e-4 if args.preset == "lm100m" else 3e-3}
    out = audit(args.preset, ranks=args.ranks, n_pods=args.pods,
                n_clusters=args.clusters, formats=args.formats, train=train,
                device=args.device)
    bad = [k for k, v in out["cases"].items() if not v["equal"]
           or any(c != v["expected"] for c in v["collectives"])]
    print(json.dumps({"cases": len(out["cases"]), "differ": bad,
                      "seconds": out["seconds"]}))
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
