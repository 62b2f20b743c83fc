"""Discrete-event simulation of Hermes and the SOTA baselines (paper §V;
the reference's ``core/simulator.py``, the per-worker loops).

Every framework trains *real* PyTorch model replicas, on the card unless
``run_framework(..., device="cpu")``; only time is simulated (per the
paper's cost model).  Implemented frameworks:

    bsp      — Bulk Synchronous Parallel (Eq. 1: barrier + gradient average)
    asp      — Asynchronous Parallel (Eq. 2: immediate delta application)
    ssp      — Stale Synchronous Parallel (staleness bound s)
    ebsp     — Elastic BSP (ZipLine-lite dynamic barriers, lookahead R,
               plus the benchmarking phase the paper criticizes)
    selsync  — Selective Synchronization (relative-gradient-change trigger)
    hermes   — the paper: GUP gate + loss-based SGD + dynamic allocation +
               prefetching + compressed pushes

Outputs a RunResult with everything Table III and Figs. 11-14 report.
The simulated clock, the allocator and the meter are numpy on the host
and match the reference's to the last bit; the losses that drive the
gates come from the replicas.  Hermes's compressed pushes go through
``compress_tree``: with int4 on a card, one launch of the grouped
``pack_int4`` kernel and one of ``unpack_int4`` a push.
"""
from __future__ import annotations

import dataclasses
import heapq
import time as _time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import HermesConfig
from repro_torch.core.allocator import (Allocation, kmeans_1d, reallocate,
                                        should_readmit)
from repro_torch.core.cluster import (
    CommModel,
    EdgeWorker,
    Meter,
    ModelBundle,
    default_cluster,
    _make_step,
    _make_eval,
)
from repro_torch.core.gup import gup_init, gup_update
from repro_torch.core.loss_sgd import ps_init, ps_push
from repro_torch.data.synthetic import dirichlet_partition, iid_partition
from repro_torch.dist.compression import compress_tree, payload_bytes
from repro_torch.dist.wire import GeneratorNoise, NoiseFn
from repro_torch.utils.trees import tree_leaves, tree_map

Tree = Any

def comp_noise(seed: int, device) -> NoiseFn:
    """The int4 dither of Hermes's pushes: push ``k``'s leaf ``i`` draws
    under ``(round_step=k, leaf=i)``, as the reference folds
    ``PRNGKey(seed)`` by the push count and then by the leaf."""
    return GeneratorNoise(seed, device)


@dataclasses.dataclass
class RunResult:
    framework: str
    iterations: int                 # total local iterations across workers
    ps_updates: int
    sim_time: float                 # simulated seconds to convergence/stop
    wall_time: float
    conv_acc: float                 # best global accuracy observed
    reached_target: bool
    target_acc: float
    api_calls: int
    bytes_transferred: float
    wi_avg: float
    history: List[Tuple[float, float]]          # (sim_time, accuracy)
    worker_iter_times: Dict[str, List[float]]   # per-worker iteration times
    gup_trace: List[Tuple[float, str, float, bool]]  # (t, worker, loss, push)
    alloc_trace: List[Tuple[float, str, int, int]]   # (t, worker, dss, mbs)
    calls_by_kind: Dict[str, int]
    bytes_by_kind: Dict[str, float]
    # every metered PS contact as (sim_t, worker, kind, nbytes) — the
    # failure-path audit trail (nothing may be billed at/after a death)
    meter_events: List[Tuple[Optional[float], str, str, float]] = \
        dataclasses.field(default_factory=list)
    # simulated seconds workers spent stalled on push/pull round trips:
    # the serial comm+PS-service wait in a synchronous Hermes round, or —
    # with HermesConfig.async_rounds — only the residue of an in-flight
    # round trip that outlived the one iteration of compute it overlapped
    # with.  comm_stall / sim_time is the pipeline-bubble fraction the
    # reference's async bench reports (benchmarks/straggler.py).
    comm_stall: float = 0.0
    # the port's own: the devices the workers' parameters are on at the
    # end of the run ("cuda:0" for a run on the card; "host" for the
    # batch engine, which uses no tensor)
    device: str = ""

    def wi_table(self) -> Dict[str, float]:
        return {}


class _Env:
    """Shared setup for every framework loop."""

    def __init__(self, bundle: ModelBundle, *, num_workers: int,
                 hermes_cfg: Optional[HermesConfig], seed: int,
                 init_alloc: Allocation, noniid: bool,
                 device: torch.device,
                 compression: str = "none",
                 failure_timeout_factor: float = 3.0):
        self.bundle = bundle
        self.seed = seed
        self.device = device
        self.rng = np.random.default_rng(seed)
        # drawn on the CPU, so a run on the card starts where one on the
        # CPU does
        self.params0 = bundle.init(torch.Generator().manual_seed(seed),
                                   device)
        # the training set lives on the device once; steps gather there
        self.train = {k: torch.as_tensor(v, device=device)
                      for k, v in bundle.train_data.items()}
        self.step_fn = _make_step(bundle)
        self.loss_j, self.acc_j = _make_eval(bundle)
        self.comm = CommModel()
        self.meter = Meter()
        self.failure_timeout_factor = failure_timeout_factor
        self.specs = default_cluster(num_workers, seed=seed)
        self.n_train = n_train = len(next(iter(bundle.train_data.values())))
        self.noniid = noniid
        if noniid:
            parts = dirichlet_partition(bundle.train_data["labels"],
                                        num_workers, seed=seed)
        else:
            parts = iid_partition(n_train, num_workers, seed=seed)
        # each worker's full partition; non-IID reallocation must redraw
        # from HERE, not from the global train set, or a Dirichlet-skewed
        # worker silently becomes IID again (IID redraws keep the whole
        # train set as their pool — the split carries no distribution)
        self.parts: List[np.ndarray] = [np.asarray(p) for p in parts]
        self.workers: List[EdgeWorker] = []
        for i, spec in enumerate(self.specs):
            shard = parts[i]
            take = min(init_alloc.dss, len(shard))
            idx = self.rng.choice(shard, size=take, replace=False)
            w = EdgeWorker(spec, self.params0, np.sort(idx), init_alloc,
                           bundle, hermes_cfg, seed + i, self.train)
            self.workers.append(w)
            # initial dataset transfer from the PS
            self.meter.call(spec.name, "data",
                            take * self._sample_bytes(), t=0.0)
        # evaluation batches
        te = bundle.test_data
        n_test = len(te["labels"])
        eb = min(bundle.eval_batch, n_test)
        sel = self.rng.choice(n_test, size=eb, replace=False)
        self.eval_batch = {k: torch.as_tensor(v[sel], device=device)
                           for k, v in te.items()}
        self.test_full = {k: torch.as_tensor(v, device=device)
                          for k, v in te.items()}
        self.params_bytes = bundle.nbytes(self.params0)
        # per-leaf registry billing for one compressed push of the model
        # delta; payload_bytes is *measured* from the encoded payload
        # arrays (trimmed wire q/q_packed + per-leaf scales), so Level A
        # bills exactly the bytes the encoded push holds
        self.push_wire_bytes = (payload_bytes(self.params0, compression)
                                if compression != "none"
                                else self.params_bytes)
        self.failures: Dict[str, float] = {}
        # {name: sim_time the node comes back} — eligibility, not admission
        self.recoveries: Dict[str, float] = {}
        # {name: sim_time it was actually re-admitted} — set by the run
        # loop once the re-admission policy (should_readmit) says yes
        self.readmitted: Dict[str, float] = {}

    def _sample_bytes(self) -> float:
        one = {k: v[:1] for k, v in self.bundle.train_data.items()}
        return float(sum(v.nbytes for v in one.values()))

    def dead(self, worker: "EdgeWorker", at_time: float) -> bool:
        t = self.failures.get(worker.spec.name)
        if t is None or at_time < t:
            return False
        r = self.readmitted.get(worker.spec.name)
        return r is None or at_time < r

    def partition_cap(self, i: int) -> int:
        """Max samples worker ``i`` can be allocated: its Dirichlet
        partition size when non-IID, the whole train set when IID."""
        return len(self.parts[i]) if self.noniid else self.n_train

    def redraw_indices(self, i: int, dss: int) -> np.ndarray:
        """Redraw worker ``i``'s shard for a new allocation.  Non-IID
        redraws come from the worker's own partition, preserving the class
        skew; IID redraws come from the full train set (pre-existing
        semantics — the IID split is bookkeeping, not a distribution)."""
        pool = (self.parts[i] if self.noniid
                else np.arange(self.n_train))
        take = min(dss, len(pool))
        return np.sort(self.rng.choice(pool, size=take, replace=False))

    def worker_eval_loss(self, params) -> float:
        return float(self.loss_j(params, self.eval_batch))

    def global_accuracy(self, params) -> float:
        return float(self.acc_j(params, self.test_full))


def _mean_params(trees: List[Tree]) -> Tree:
    n = float(len(trees))
    return tree_map(lambda *xs: sum(xs) / n, *trees)


def _delta_apply(base: Tree, old: Tree, new_local: Tree) -> Tree:
    """ASP: base + (new_local - old) — Hogwild-style delta application."""
    return tree_map(lambda b, o, n: b + (n - o), base, old, new_local)


def _norm(tree: Tree) -> float:
    """The L2 norm over every leaf of ``tree``."""
    return float(torch.sqrt(sum(torch.vdot(x.reshape(-1), x.reshape(-1))
                                for x in tree_leaves(tree))))


@dataclasses.dataclass
class _StopCfg:
    target_acc: float
    max_iterations: int
    max_sim_time: float
    max_wall: float
    eval_every: int      # global accuracy eval every N PS updates
    patience: int


def _check_stop(acc_best, reached, iters, sim_t, t0_wall, stop: _StopCfg,
                stale_evals: int) -> bool:
    if reached:
        return True
    if iters >= stop.max_iterations or sim_t >= stop.max_sim_time:
        return True
    if (_time.time() - t0_wall) >= stop.max_wall:
        return True
    if stale_evals >= stop.patience:
        return True
    return False


def run_framework(framework: str, bundle: ModelBundle, *,
                  num_workers: int = 12,
                  hermes_cfg: Optional[HermesConfig] = None,
                  seed: int = 0,
                  init_alloc: Allocation = Allocation(256, 16),
                  noniid: bool = False,
                  target_acc: float = 0.95,
                  max_iterations: int = 20000,
                  max_sim_time: float = 1e6,
                  max_wall: float = 600.0,
                  eval_every: int = 5,
                  patience: int = 40,
                  ssp_s: int = 125,
                  ebsp_r: int = 150,
                  selsync_delta: float = 1.0,
                  alloc_every: float = 30.0,
                  failures: Optional[Dict[str, float]] = None,
                  recoveries: Optional[Dict[str, float]] = None,
                  engine: str = "auto",
                  churn: Optional[Any] = None,
                  device="cuda") -> RunResult:
    """Run one framework on a simulated cluster of ``num_workers`` Table-II
    workers, the replicas on ``device`` (the card unless the caller asks
    for the CPU; without a card the default raises).

    ``failures``: {worker_name: sim_time} — the node dies (stops
    responding) at that simulated time.  Asynchronous frameworks tolerate
    this natively (dead workers simply stop contributing); BSP excludes a
    worker once it misses the barrier, after the failure detection timeout
    (``hermes_cfg.failure_timeout_factor`` x the typical iteration time —
    the detection stall and the survivors' compute elapse concurrently, so
    the barrier pays their max, not their sum).  EBSP has no failure path:
    it models the paper's benchmark-then-schedule baseline only, so pass
    ``failures`` to bsp/asp/ssp/selsync/hermes runs.

    ``recoveries``: {worker_name: sim_time} — a failed node comes back at
    that time (strictly after its death).  Only Hermes has a grow path:
    the recovered worker is re-admitted iff the re-admission policy
    (``should_readmit``: enough expected rounds remain to amortize
    ``hermes_cfg.rejoin_cost_rounds``) approves, in which case it pulls
    the current global model, restarts with fresh GUP state and a zeroed
    compression residual, re-enters the allocator sweep seeded at the
    median observed iteration time, and is billed the pull + dataset
    transfer; a denied rejoin leaves it excluded (one ``rejoin_denied``
    meter event, no bytes).

    ``engine``: ``"legacy"`` runs the per-worker loops below;
    ``"vector"`` is the reference's exact slot scheduler, whose runs equal
    the legacy loops' (every framework but EBSP, which it refuses), so it
    runs the same loops here and adds only Level-A participation
    admission (``participation_rate < 1`` under ``prob``), which the
    reference's legacy loop ignores;
    ``"auto"`` is legacy for a ``ModelBundle`` and the engine's
    batch/surrogate mode for a ``SurrogateBundle`` or a ``churn`` trace
    (a ``ChurnTrace``), which runs Hermes on numpy columns on the host.
    ``device`` is resolved in every case: the batch mode needs no card,
    but a caller without one says ``device="cpu"`` as for any run."""
    hermes_cfg = hermes_cfg or HermesConfig()
    if engine not in ("auto", "legacy", "vector"):
        raise ValueError(f"unknown engine {engine!r}")
    # deferred: the engine imports this module's helpers
    from repro_torch.core import engine as _engine
    stop = _StopCfg(target_acc, max_iterations, max_sim_time, max_wall,
                    eval_every, patience)
    if isinstance(bundle, _engine.SurrogateBundle) or churn is not None:
        if engine == "legacy":
            raise ValueError(
                "churn traces / surrogate bundles need the vectorized "
                "batch engine; drop engine='legacy'")
        if not isinstance(bundle, _engine.SurrogateBundle):
            raise ValueError(
                "churn traces run on the batch engine: pass a "
                "SurrogateBundle (real-bundle churn is the failures/"
                "recoveries path)")
        if failures or recoveries:
            raise ValueError(
                "the batch engine models churn via ChurnTrace, not "
                "failures/recoveries")
        resolve_device(device)
        return _engine.run_batch(framework, bundle, num_workers=num_workers,
                                 hcfg=hermes_cfg, seed=seed,
                                 init_alloc=init_alloc, stop=stop,
                                 alloc_every=alloc_every, churn=churn)
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the models are fp32: keep TF32 out of every matmul and conv
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    compression = hermes_cfg.compression if framework == "hermes" else "none"
    env = _Env(bundle, num_workers=num_workers,
               hermes_cfg=hermes_cfg if framework == "hermes" else None,
               seed=seed, init_alloc=init_alloc, noniid=noniid, device=dev,
               compression=compression,
               failure_timeout_factor=hermes_cfg.failure_timeout_factor)
    env.failures = failures or {}
    env.recoveries = recoveries or {}
    for name, rt in env.recoveries.items():
        ft = env.failures.get(name)
        if ft is None:
            raise ValueError(f"recovery for {name!r} without a failure")
        if rt <= ft:
            raise ValueError(
                f"recovery for {name!r} at t={rt} not after its death "
                f"at t={ft}")
    if env.recoveries and framework != "hermes":
        raise ValueError(
            "only hermes has a re-admission (grow) path; pass recoveries "
            "to hermes runs")
    if engine == "vector" and framework == "ebsp":
        raise ValueError(
            "ebsp has no vectorized port (it models the benchmark-"
            "then-schedule baseline only); use engine='legacy'")
    if framework == "bsp":
        return _run_bsp(env, stop)
    if framework == "asp":
        return _run_async(env, stop, mode="asp")
    if framework == "ssp":
        return _run_async(env, stop, mode="ssp", ssp_s=ssp_s)
    if framework == "ebsp":
        return _run_ebsp(env, stop, lookahead=ebsp_r)
    if framework == "selsync":
        return _run_async(env, stop, mode="selsync", selsync_delta=selsync_delta)
    if framework == "hermes":
        return _run_hermes(env, stop, hermes_cfg, alloc_every=alloc_every,
                           admit=engine == "vector")
    if engine == "vector":
        raise ValueError(
            f"engine='vector' has no exact-mode port of {framework!r}; "
            "use engine='legacy'")
    raise KeyError(framework)


# ---------------------------------------------------------------------------
# BSP
# ---------------------------------------------------------------------------

def _bsp_barrier(sim_t: float, durations: List[float], typical: float,
                 any_dead: bool, factor: float) -> float:
    """When a superstep loses a node, the *survivors'* compute and the
    failure-detection timeout elapse concurrently: the barrier releases
    at whichever finishes last, not at their sum (the old accounting
    charged ``factor * typical`` on top of ``max(durations)``, billing the
    survivors' compute twice).  ``durations`` must be the surviving
    workers' durations — a dead node never finishes its iteration, so its
    phantom compute must not stretch the barrier either."""
    barrier = sim_t + max(durations)
    if any_dead:
        barrier = max(barrier, sim_t + factor * typical)
    return barrier


def _run_bsp(env: _Env, stop: _StopCfg) -> RunResult:
    t0 = _time.time()
    w_global = env.params0
    sim_t = 0.0
    acc_best, reached, stale = 0.0, False, 0
    history: List[Tuple[float, float]] = []
    itimes: Dict[str, List[float]] = {w.spec.name: [] for w in env.workers}
    superstep = 0
    eval_n = env.eval_batch["labels"].shape[0]

    excluded: set = set()
    while True:
        superstep += 1
        durations = []
        alive = [w for w in env.workers if w.spec.name not in excluded]
        if not alive:
            break
        dur: Dict[str, float] = {}
        for w in alive:
            w.params = w_global
            w.mom = tree_map(torch.zeros_like, w.mom)
            d = w.sim_iteration_time(eval_n)
            durations.append(d)
            dur[w.spec.name] = d
            itimes[w.spec.name].append(d)
            w.run_local_iteration(env.step_fn, env.loss_j,
                                  {k: v for k, v in env.eval_batch.items()})
            w.clock = sim_t + d
        # failure detection: a node that dies before reaching the barrier
        # stalls it for the detection timeout, then is excluded.  The stall
        # and the survivors' compute elapse concurrently, and a dead node's
        # phantom compute never extends the barrier (_bsp_barrier), so the
        # barrier is re-derived from the survivors until it settles: each
        # pass can only exclude more workers, so it terminates.  A node
        # dying inside the stall window also never reaches the barrier and
        # must not be billed a push it never sent.
        typical = float(np.median(durations))
        any_dead = False
        barrier = sim_t + max(dur[w.spec.name] for w in alive)
        while True:
            newly_dead = [w for w in alive if env.dead(w, barrier)]
            if not newly_dead:
                break
            any_dead = True
            for w in newly_dead:
                excluded.add(w.spec.name)
            alive = [w for w in alive if w.spec.name not in excluded]
            if not alive:
                break
            barrier = _bsp_barrier(sim_t,
                                   [dur[w.spec.name] for w in alive],
                                   typical, True,
                                   env.failure_timeout_factor)
        if not alive:
            break
        # push gradients + pull model (every survivor, every superstep)
        push_t = env.comm.time(env.params_bytes)
        pull_t = env.comm.time(env.params_bytes)
        for w in alive:
            env.meter.call(w.spec.name, "push", env.params_bytes, t=barrier)
            env.meter.call(w.spec.name, "pull", env.params_bytes, t=barrier)
            w.model_pulls += 1
        w_global = _mean_params([w.params for w in alive])
        sim_t = barrier + push_t + pull_t
        iters = sum(w.iterations for w in env.workers)
        if superstep % stop.eval_every == 0 or superstep == 1:
            acc = env.global_accuracy(w_global)
            history.append((sim_t, acc))
            stale = stale + 1 if acc <= acc_best + 1e-4 else 0
            acc_best = max(acc_best, acc)
            reached = reached or acc >= stop.target_acc
        if _check_stop(acc_best, reached, iters, sim_t, t0, stop, stale):
            break

    return _result("bsp", env, sim_t, t0, acc_best, reached, stop, history,
                   itimes, [], [], ps_updates=superstep)


# ---------------------------------------------------------------------------
# ASP / SSP / SelSync (event-driven, per-worker loop)
# ---------------------------------------------------------------------------

def _run_async(env: _Env, stop: _StopCfg, *, mode: str, ssp_s: int = 125,
               selsync_delta: float = 1.0) -> RunResult:
    t0 = _time.time()
    w_global = env.params0
    acc_best, reached, stale = 0.0, False, 0
    history: List[Tuple[float, float]] = []
    itimes: Dict[str, List[float]] = {w.spec.name: [] for w in env.workers}
    eval_n = env.eval_batch["labels"].shape[0]
    heap: List[Tuple[float, int, int]] = []
    pulled: Dict[int, Tree] = {}
    prev_delta_norm: Dict[int, float] = {}
    prev_delta: Dict[int, Tree] = {}
    ps_updates = 0
    sim_t = 0.0

    for i, w in enumerate(env.workers):
        w.params = w_global
        pulled[i] = w_global
        d = w.sim_iteration_time(eval_n)
        itimes[w.spec.name].append(d)
        heapq.heappush(heap, (d, i, 0))

    while heap:
        sim_t, i, _ = heapq.heappop(heap)
        w = env.workers[i]
        if env.dead(w, sim_t):
            continue  # node failure: it simply never reports back
        w.clock = sim_t
        # SSP staleness gate: block until within s of the slowest worker
        if mode == "ssp":
            min_iter = min(x.iterations for x in env.workers
                           if not env.dead(x, sim_t))
            if w.iterations > min_iter + ssp_s:
                heapq.heappush(heap, (sim_t + 0.05, i, 1))
                continue
        w.run_local_iteration(env.step_fn, env.loss_j, env.eval_batch)

        do_sync = True
        if mode == "selsync":
            # SelSync's relative gradient change: ||d_t - d_{t-1}|| / ||d_{t-1}||
            delta = tree_map(lambda n, o: n - o, w.params, pulled[i])
            prev = prev_delta.get(i)
            if prev is None:
                rel = float("inf")  # first iteration: sync
            else:
                diff = tree_map(lambda a, b: a - b, delta, prev)
                rel = _norm(diff) / max(_norm(prev), 1e-9)
            prev_delta[i] = delta
            do_sync = rel > selsync_delta

        if do_sync:
            env.meter.call(w.spec.name, "push", env.params_bytes, t=sim_t)
            w_global = _delta_apply(w_global, pulled[i], w.params)
            ps_updates += 1
            env.meter.call(w.spec.name, "pull", env.params_bytes, t=sim_t)
            w.refresh(w_global)
            pulled[i] = w_global
            comm = env.comm.time(env.params_bytes) * 2
        else:
            env.meter.call(w.spec.name, "telemetry", 128, t=sim_t)
            comm = 0.0

        d = w.sim_iteration_time(eval_n)
        itimes[w.spec.name].append(d)
        heapq.heappush(heap, (sim_t + comm + d, i, 0))

        iters = sum(x.iterations for x in env.workers)
        if ps_updates and ps_updates % (stop.eval_every * len(env.workers)) == 0:
            acc = env.global_accuracy(w_global)
            history.append((sim_t, acc))
            stale = stale + 1 if acc <= acc_best + 1e-4 else 0
            acc_best = max(acc_best, acc)
            reached = reached or acc >= stop.target_acc
        if _check_stop(acc_best, reached, iters, sim_t, t0, stop, stale):
            break

    if not history:
        acc_best = env.global_accuracy(w_global)
        history.append((sim_t, acc_best))
    return _result(mode, env, sim_t, t0, acc_best, reached, stop, history,
                   itimes, [], [], ps_updates=ps_updates)


# ---------------------------------------------------------------------------
# EBSP (ZipLine-lite)
# ---------------------------------------------------------------------------

def _run_ebsp(env: _Env, stop: _StopCfg, *, lookahead: int) -> RunResult:
    t0 = _time.time()
    w_global = env.params0
    sim_t = 0.0
    acc_best, reached, stale = 0.0, False, 0
    history: List[Tuple[float, float]] = []
    itimes: Dict[str, List[float]] = {w.spec.name: [] for w in env.workers}
    eval_n = env.eval_batch["labels"].shape[0]
    ewma = {i: None for i in range(len(env.workers))}
    ps_updates = 0

    # benchmarking phase (the overhead the paper criticizes)
    for i, w in enumerate(env.workers):
        bt = 0.0
        for _ in range(3):
            bt += w.sim_iteration_time(eval_n)
        ewma[i] = bt / 3
        env.meter.call(w.spec.name, "benchmark", 1024, n=3, t=0.0)
    sim_t += max(ewma.values())

    while True:
        # choose barrier: candidate times are k-th completions of each worker
        # within `lookahead` iterations of the fastest; minimize total idle.
        preds = {i: ewma[i] for i in ewma}
        fastest = min(preds.values())
        best_T, best_idle = None, float("inf")
        for i in preds:
            for k in range(1, max(2, int(lookahead * fastest / preds[i]) + 1)):
                T = sim_t + preds[i] * k
                if T - sim_t > lookahead * fastest:
                    continue
                idle = 0.0
                for j in preds:
                    m = max(1, int((T - sim_t) // preds[j]))
                    idle += (T - sim_t) - m * preds[j]
                if idle < best_idle:
                    best_idle, best_T = idle, T
        T = best_T or (sim_t + max(preds.values()))

        # each worker runs as many local iterations as fit before T
        for i, w in enumerate(env.workers):
            w.params = w_global
            m = max(1, int((T - sim_t) // preds[i]))
            for _ in range(m):
                d = w.sim_iteration_time(eval_n)
                itimes[w.spec.name].append(d)
                ewma[i] = 0.7 * ewma[i] + 0.3 * d
                w.run_local_iteration(env.step_fn, env.loss_j, env.eval_batch)
            env.meter.call(w.spec.name, "push", env.params_bytes, t=T)
            env.meter.call(w.spec.name, "pull", env.params_bytes, t=T)
            w.model_pulls += 1
        w_global = _mean_params([w.params for w in env.workers])
        ps_updates += 1
        sim_t = T + env.comm.time(env.params_bytes) * 2

        iters = sum(x.iterations for x in env.workers)
        if ps_updates % stop.eval_every == 0 or ps_updates == 1:
            acc = env.global_accuracy(w_global)
            history.append((sim_t, acc))
            stale = stale + 1 if acc <= acc_best + 1e-4 else 0
            acc_best = max(acc_best, acc)
            reached = reached or acc >= stop.target_acc
        if _check_stop(acc_best, reached, iters, sim_t, t0, stop, stale):
            break

    return _result("ebsp", env, sim_t, t0, acc_best, reached, stop, history,
                   itimes, [], [], ps_updates=ps_updates)


# ---------------------------------------------------------------------------
# Hermes
# ---------------------------------------------------------------------------

def _run_hermes(env: _Env, stop: _StopCfg, hcfg: HermesConfig, *,
                alloc_every: float, admit: bool = False) -> RunResult:
    t0 = _time.time()
    ps = ps_init(env.params0, hcfg.eta)
    eta = env.bundle.eta
    acc_best, reached, stale = 0.0, False, 0
    history: List[Tuple[float, float]] = []
    itimes: Dict[str, List[float]] = {w.spec.name: [] for w in env.workers}
    gup_trace: List[Tuple[float, str, float, bool]] = []
    alloc_trace: List[Tuple[float, str, int, int]] = []
    eval_n = env.eval_batch["labels"].shape[0]
    heap: List[Tuple[float, int, int, int]] = []
    sim_t = 0.0
    ps_busy_until = 0.0
    last_alloc_check = 0.0
    latest_times: Dict[str, float] = {}
    prefetch_ready: Dict[int, float] = {}
    # async double-buffered rounds: {worker: sim_t its in-flight push's
    # round trip lands}.  The worker keeps computing through one
    # iteration (staleness-1); the iteration after that may not start
    # before the merged global is back.
    merge_ready: Dict[int, float] = {}
    async_rounds = bool(getattr(hcfg, "async_rounds", False))
    comm_stall = 0.0
    # Two-tier topology (DESIGN.md §10): with n_clusters > 1 a push pays
    # the fast intra-cluster hop at full wire bytes, but the slow
    # cluster-crossing hop ships at most ONE payload per cluster at a
    # time — a push landing while its cluster's aggregator is still
    # shipping piggybacks on the in-flight merged payload (no new slow
    # bytes, arrival clamped to the aggregator's landing).  That is the
    # Level-A shadow of hermes_cluster_merge: slow-tier model-sized
    # bytes scale with n_clusters, not n_pods.  Assignment is k-means
    # over the allocator's observed iteration times, refreshed at the
    # sweep cadence; until the first sweep everyone sits in cluster 0.
    # With n_clusters == 1 none of this runs and billing is bit-for-bit
    # the flat path.
    n_clusters = max(1, int(getattr(hcfg, "n_clusters", 1) or 1))
    clustered = n_clusters > 1
    fast_comm = CommModel(latency=env.comm.latency * 0.25,
                          bandwidth=env.comm.bandwidth * 4.0)
    cluster_of: Dict[str, int] = {}
    cluster_busy: Dict[int, float] = {}
    n_train = env.n_train
    w_global = env.params0
    comp_err: Dict[int, Tree] = {}   # per-worker error-feedback residual
    # stochastic-format dither stream; seed-derived so replicate runs with
    # different seeds draw independent quantization noise
    noise = comp_noise(env.seed ^ 0x51ED, env.device)
    comp_pushes = 0
    # Level-A participation admission, for engine="vector" only (the
    # reference's legacy loop ignores the rate), on its own stream: it
    # draws only at participation_rate < 1 under ``prob``, so env.rng's
    # sequence, and with it the ungated trajectory, is untouched
    prate = float(getattr(hcfg, "participation_rate", 1.0))
    adm_rng = (np.random.default_rng(env.seed ^ 0xAD317)
               if admit and prate < 1.0
               and getattr(hcfg, "admission", "topk") == "prob" else None)

    # per-worker event epoch: bumped at re-admission so an in-flight
    # pre-death completion event that lands *after* the rejoin cannot
    # fork a second event chain (it would double-count every iteration
    # and byte for the rest of the run)
    epoch = [0] * len(env.workers)

    for i, w in enumerate(env.workers):
        d = w.sim_iteration_time(eval_n)
        itimes[w.spec.name].append(d)
        heapq.heappush(heap, (d, i, 0, 0))
        # a failed node that recovers re-enters the loop as a rejoin
        # event (kind 2), subject to the re-admission policy below
        if w.spec.name in env.recoveries:
            heapq.heappush(heap, (env.recoveries[w.spec.name], i, 2, 0))

    def ps_eval(params) -> float:
        return env.worker_eval_loss(params)

    while heap:
        sim_t, i, kind, ev_epoch = heapq.heappop(heap)
        w = env.workers[i]
        if kind == 2:
            # the node is back.  Re-admission policy first: the rejoin
            # stall (model pull + dataset transfer + fresh state) only
            # pays off when enough rounds remain to amortize it, so a
            # recovery near the end of the run is declined outright —
            # one telemetry-free meter event, no bytes.
            live_n = sum(1 for x in env.workers if not env.dead(x, sim_t))
            iters_done = sum(x.iterations for x in env.workers)
            # remaining rounds at the CURRENT membership; should_readmit
            # itself applies the /(n+1) post-join speedup (DESIGN.md §7)
            remaining_rounds = max(
                0.0, (stop.max_iterations - iters_done) / max(1, live_n))
            if not should_readmit(remaining_rounds, live_n, hcfg):
                # audit-trail event only: n=0 keeps it out of the paper's
                # PS-contact count (RunResult.api_calls)
                env.meter.call(w.spec.name, "rejoin_denied", 0.0, n=0,
                               t=sim_t)
                continue
            env.readmitted[w.spec.name] = sim_t
            epoch[i] += 1  # invalidate any in-flight pre-death event
            w.clock = sim_t
            # seeded exactly like a Level-B newcomer: current global
            # model, fresh GUP state, no pending compression residual
            env.meter.call(w.spec.name, "pull", env.params_bytes, t=sim_t)
            w.refresh(w_global)
            w.mom = tree_map(torch.zeros_like, w.mom)
            w.gup = gup_init(hcfg)
            comp_err.pop(i, None)
            # a pre-death in-flight round trip must not clamp (or bill)
            # the reborn worker — the elastic flush rule, Level-A form
            merge_ready.pop(i, None)
            # re-enter the allocator sweep at the median observed
            # iteration time — the newcomer has no fresh measurement yet
            if latest_times:
                latest_times[w.spec.name] = float(
                    np.median(list(latest_times.values())))
            # clamp to the redraw pool (non-IID: the worker's own
            # partition), like the sweep path — the cost model must
            # never bill compute for samples the worker does not hold
            alloc = w.alloc
            cap = env.partition_cap(i)
            if alloc.dss > cap:
                alloc = Allocation(cap, alloc.mbs)
            idx = env.redraw_indices(i, alloc.dss)
            w.set_allocation(alloc, idx)
            xfer = len(idx) * env._sample_bytes()
            env.meter.call(w.spec.name, "data", xfer, t=sim_t)
            start = (sim_t + env.comm.time(env.params_bytes)
                     + env.comm.time(xfer))
            d = w.sim_iteration_time(eval_n)
            itimes[w.spec.name].append(d)
            heapq.heappush(heap, (start + d, i, 0, epoch[i]))
            continue
        if ev_epoch != epoch[i]:
            # an iteration that started before the death never completed;
            # its completion event must not revive a parallel chain
            continue
        if env.dead(w, sim_t):
            # failed node: its pushes simply stop arriving, and its stale
            # iteration time must leave the allocator's observation set or
            # the sweep keeps feeding a node that will never run again
            latest_times.pop(w.spec.name, None)
            continue
        w.clock = sim_t
        loss = w.run_local_iteration(env.step_fn, env.loss_j, env.eval_batch)
        latest_times[w.spec.name] = itimes[w.spec.name][-1]
        env.meter.call(w.spec.name, "telemetry", 64, t=sim_t)
        push, _ = gup_update(w.gup, loss)
        gup_trace.append((sim_t, w.spec.name, loss, push))

        next_start = sim_t
        # consume the previous in-flight round trip BEFORE a new push can
        # start one: its landing time clamps this worker's next iteration
        pending_back = merge_ready.pop(i, None)
        if push and adm_rng is not None and not (adm_rng.random() < prate):
            # the gate stays advanced (the raw decision above); the
            # w0-anchored G and any compression residual ride the next
            # admitted push.  Zero-byte audit event, not a PS contact.
            env.meter.call(w.spec.name, "push_deferred", 0.0, n=0, t=sim_t)
        elif push:
            # G measured from w0 (Algorithm 2's Worker-SGD accumulation)
            G = tree_map(lambda w0_, wl: (w0_ - wl) / eta, ps.w0, w.params)
            # The wire applies the configured format to the push: the PS
            # merges the receiver-side reconstruction and the worker carries
            # the dropped residual forward (error feedback) — the same
            # encode as the Level-B merge, so Level A and Level B
            # reconstruct identically.  The push bills the per-leaf
            # registry payload_bytes; the pull ships (and bills) the exact
            # uncompressed global model, matching what refresh() applies.
            if hcfg.compression != "none":
                G, residual = compress_tree(
                    G, hcfg.compression,
                    error=comp_err.get(i) if hcfg.error_feedback else None,
                    round_step=comp_pushes, noise=noise)
                if hcfg.error_feedback:
                    comp_err[i] = residual
                comp_pushes += 1
            env.meter.call(w.spec.name, "push", env.push_wire_bytes, n=1,
                           t=sim_t)
            if clustered:
                # fast hop always ships the worker's own payload; the
                # slow hop is billed only when this push has to open a
                # new cluster-crossing transfer (the aggregator idle)
                c = cluster_of.get(w.spec.name, 0)
                fast_arrive = sim_t + fast_comm.time(env.push_wire_bytes)
                busy = cluster_busy.get(c, 0.0)
                if busy > fast_arrive:
                    arrive = busy
                else:
                    arrive = fast_arrive + env.comm.time(env.push_wire_bytes)
                    cluster_busy[c] = arrive
                    env.meter.call(w.spec.name, "push_cluster",
                                   env.push_wire_bytes, n=1, t=sim_t)
            else:
                arrive = sim_t + env.comm.time(env.push_wire_bytes)
            start = max(arrive, ps_busy_until)
            ps, w_global, _m = ps_push(ps, G, ps_eval)
            ps_time = 0.004 * _m["evals"] * max(1.0, eval_n / 64)
            ps_busy_until = start + ps_time
            env.meter.call(w.spec.name, "pull", env.params_bytes, t=sim_t)
            back = ps_busy_until + env.comm.time(env.params_bytes)
            w.refresh(w_global)
            w.mom = tree_map(torch.zeros_like, w.mom)
            if async_rounds:
                # the push transfer + PS service + pull overlap the next
                # iteration's compute: the worker continues immediately
                # and only the iteration after next can stall on the
                # round trip (the merge_ready clamp below).  The state
                # update stays at this event — the discrete-event model
                # applies the merge logically here; async changes what
                # the round trip is *billed* against, not the math.
                merge_ready[i] = back
            else:
                comm_stall += back - sim_t
                next_start = back

        # allocator sweep (asynchronous monitoring).  Dead workers drop out
        # of the sweep entirely: a failed worker's stale latest_times entry
        # would keep skewing the IQR fences, and reallocating one would
        # bill dataset bytes to a node that will never run again.  The
        # sweep runs down to 2 live observations (the old >= 4 floor
        # silently switched dynamic allocation off exactly when deaths
        # shrank the cluster into the straggler regime the paper targets);
        # a sweep skipped for want of observations is metered, not silent.
        if sim_t - last_alloc_check >= alloc_every:
            last_alloc_check = sim_t
            for x in env.workers:
                if env.dead(x, sim_t):
                    latest_times.pop(x.spec.name, None)
            if clustered and latest_times:
                # re-cluster on the same observation set the allocator
                # sweeps; a dead worker's entry was just dropped, so its
                # cluster re-forms around the survivors (the assignment is
                # deterministic and stable under drops)
                cluster_of = kmeans_1d(latest_times, n_clusters)
            if len(latest_times) < 2:
                # audit-trail event only (n=0): not a PS API contact
                env.meter.call("allocator", "alloc_skip", 0.0, n=0, t=sim_t)
                new = {}
            else:
                live = [x for x in env.workers if not env.dead(x, sim_t)]
                allocs = {x.spec.name: x.alloc for x in live}
                mem = {x.spec.name: x.spec.mem_limit_dss for x in live}
                new = reallocate(
                    latest_times, allocs, hcfg,
                    dss_domain=(32, max(64, n_train // max(1, len(live)))),
                    mem_limit_dss=mem)
            for j, x in enumerate(env.workers):
                if x.spec.name in new and not env.dead(x, sim_t):
                    a = new[x.spec.name]
                    # redraw from the worker's redraw pool: a Dirichlet
                    # shard must stay a Dirichlet shard after reallocation.
                    # Clamp dss to what the pool actually holds so the
                    # cost model and alloc_trace never bill phantom samples.
                    cap = env.partition_cap(j)
                    if a.dss > cap:
                        a = Allocation(cap, a.mbs)
                    idx = env.redraw_indices(j, a.dss)
                    x.set_allocation(a, idx)
                    alloc_trace.append((sim_t, x.spec.name, a.dss, a.mbs))
                    xfer = len(idx) * env._sample_bytes()
                    env.meter.call(x.spec.name, "data", xfer, t=sim_t)
                    # prefetch: transfer overlaps with compute
                    prefetch_ready[j] = sim_t + env.comm.time(xfer)

        # next iteration (wait for prefetch only if it hasn't landed)
        if i in prefetch_ready:
            next_start = max(next_start, prefetch_ready.pop(i))
        if pending_back is not None:
            # only the residue of the overlapped round trip stalls: a
            # transfer that finished within one iteration of compute
            # costs nothing here
            comm_stall += max(0.0, pending_back - next_start)
            next_start = max(next_start, pending_back)
        d = w.sim_iteration_time(eval_n)
        itimes[w.spec.name].append(d)
        heapq.heappush(heap, (next_start + d, i, 0, epoch[i]))

        iters = sum(x.iterations for x in env.workers)
        if ps.updates and ps.updates % stop.eval_every == 0:
            acc = env.global_accuracy(w_global)
            history.append((sim_t, acc))
            stale = stale + 1 if acc <= acc_best + 1e-4 else 0
            acc_best = max(acc_best, acc)
            reached = reached or acc >= stop.target_acc
        if _check_stop(acc_best, reached, iters, sim_t, t0, stop, stale):
            break

    if not history:
        acc_best = env.global_accuracy(w_global)
        history.append((sim_t, acc_best))
    return _result("hermes", env, sim_t, t0, acc_best, reached, stop, history,
                   itimes, gup_trace, alloc_trace, ps_updates=ps.updates,
                   comm_stall=comm_stall)


# ---------------------------------------------------------------------------

def _result(name: str, env: _Env, sim_t: float, t0: float, acc_best: float,
            reached: bool, stop: _StopCfg, history, itimes, gup_trace,
            alloc_trace, *, ps_updates: int,
            comm_stall: float = 0.0) -> RunResult:
    wi = float(np.mean([w.wi() for w in env.workers]))
    return RunResult(
        framework=name,
        iterations=sum(w.iterations for w in env.workers),
        ps_updates=ps_updates,
        sim_time=sim_t,
        wall_time=_time.time() - t0,
        conv_acc=acc_best,
        reached_target=reached,
        target_acc=stop.target_acc,
        api_calls=env.meter.total_calls,
        bytes_transferred=env.meter.bytes,
        wi_avg=wi,
        history=history,
        worker_iter_times=itimes,
        gup_trace=gup_trace,
        alloc_trace=alloc_trace,
        calls_by_kind=dict(env.meter.calls_by_kind),
        bytes_by_kind=dict(env.meter.bytes_by_kind),
        meter_events=env.meter.events,
        comm_stall=comm_stall,
        device=",".join(sorted({str(x.device) for w in env.workers
                                for x in tree_leaves(w.params)})),
    )
