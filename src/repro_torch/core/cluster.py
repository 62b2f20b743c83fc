"""Heterogeneous edge-cluster substrate of the Level-A simulator (the
reference's ``core/cluster.py``).

Real training and a simulated clock: every worker performs *actual*
mini-batch SGD on its own model replica (the learning dynamics are
real), while iteration durations follow the paper's cost model ``t = K *
E * DSS / MBS`` with per-family constants derived from Table II,
multiplicative jitter, and optional degradation drift.  The simulated
times come from the same numpy generators as the reference's, so they
are equal to the last bit.

The communication model charges latency + bytes/bandwidth per message and
meters API calls as the paper's evaluation does (dataset transfer, model
pull, gradient push, telemetry).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import HermesConfig
from repro_torch.core.allocator import Allocation
from repro_torch.core.gup import GUPState, gup_init
from repro_torch.data.pipeline import ShardedLoader
from repro_torch.utils.trees import (
    tree_flatten, tree_leaves, tree_map, tree_unflatten,
)

Tree = Any


# ---------------------------------------------------------------------------
# Cluster spec (paper Table II)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkerSpec:
    name: str
    family: str
    k_base: float          # simulated seconds per mini-batch step
    mem_limit_dss: int     # max dataset size fitting worker memory
    jitter: float = 0.06   # lognormal sigma on iteration time
    drift_per_sec: float = 0.0  # multiplicative slowdown per simulated second


# Relative speeds follow Table II vCPU counts / families; B1ms is the
# straggler family, F4s_v2 the fastest.  One B1ms degrades over time.
TABLE_II_FAMILIES = [
    ("B1ms", 2, 0.055, 2000),
    ("F2s_v2", 3, 0.028, 4000),
    ("DS2_v2", 3, 0.025, 7000),
    ("E2ds_v4", 2, 0.022, 16000),
    ("F4s_v2", 2, 0.013, 8000),
]


def default_cluster(num_workers: int = 12, *, seed: int = 0,
                    degrade_one: bool = True) -> List[WorkerSpec]:
    specs: List[WorkerSpec] = []
    i = 0
    for fam, count, k, mem in TABLE_II_FAMILIES:
        for j in range(count):
            drift = 0.0
            if degrade_one and fam == "B1ms" and j == 0:
                drift = 2e-4  # slow hardware degradation
            specs.append(WorkerSpec(name=f"{fam}_{j}", family=fam, k_base=k,
                                    mem_limit_dss=mem, drift_per_sec=drift))
            i += 1
            if i >= num_workers:
                return specs
    # pad by cycling families if more workers requested
    while len(specs) < num_workers:
        fam, _, k, mem = TABLE_II_FAMILIES[len(specs) % len(TABLE_II_FAMILIES)]
        specs.append(WorkerSpec(name=f"{fam}_x{len(specs)}", family=fam,
                                k_base=k, mem_limit_dss=mem))
    return specs


# ---------------------------------------------------------------------------
# Communication model + metering
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CommModel:
    """Latency + bandwidth cost of one PS<->worker transfer.

    Callers pass the byte count that actually crosses the wire: compressed
    pushes are billed per leaf through the wire registry's
    ``payload_bytes`` (see ``simulator._Env.push_wire_bytes``), pulls ship
    the exact uncompressed model.
    """

    latency: float = 0.04          # seconds per message
    bandwidth: float = 25e6        # bytes/second PS<->worker

    def time(self, nbytes: float) -> float:
        return self.latency + nbytes / self.bandwidth


class MeterEvents:
    """Lazy sequence view over a :class:`Meter`'s chunked event columns.

    Behaves like the ``List[Tuple[Optional[float], str, str, float]]`` it
    replaced — ``len``, integer/slice indexing, iteration, tuple
    unpacking — but materializes one tuple at a time from the numpy
    columns, so holding a ``RunResult`` for a 10k-worker x 1k-round run
    costs four flat arrays instead of millions of tiny tuples."""

    def __init__(self, meter: "Meter"):
        self._m = meter

    def __len__(self) -> int:
        return self._m._n_events

    def _at(self, i: int) -> Tuple[Optional[float], str, str, float]:
        m = self._m
        c, off = divmod(i, Meter._CHUNK)
        if c < len(m._full_t):
            t = m._full_t[c][off]
            w = m._full_w[c][off]
            k = m._full_k[c][off]
            nb = m._full_nb[c][off]
        else:
            t, w, k = m._buf_t[off], m._buf_w[off], m._buf_k[off]
            nb = m._buf_nb[off]
        tf = float(t)
        return (None if np.isnan(tf) else tf, m._worker_names[int(w)],
                m._kind_names[int(k)], float(nb))

    def __getitem__(self, i):
        n = len(self)
        if isinstance(i, slice):
            return [self._at(j) for j in range(*i.indices(n))]
        j = int(i)
        if j < 0:
            j += n
        if not 0 <= j < n:
            raise IndexError(i)
        return self._at(j)

    def __iter__(self):
        for j in range(len(self)):
            yield self._at(j)

    def __repr__(self) -> str:
        return f"MeterEvents(n={len(self)})"


class Meter:
    """API-call / byte accounting (paper counts every PS contact).

    Every call is also recorded as a ``(t, worker, kind, nbytes)`` event
    (``t`` is the simulated time the caller passes, or None for untimed
    contexts), so failure-path tests can assert that nothing is ever
    billed to a worker at or after its death time.

    Events live in chunked numpy columns (timestamp, worker id, kind id,
    bytes) behind the lazy :class:`MeterEvents` view, and a batch caller
    (the reference's vectorized engine) appends whole cohorts at once via
    :meth:`call_batch` — per-call Python tuples would dominate memory and
    time at 10k workers."""

    _CHUNK = 1 << 16

    def __init__(self):
        self.bytes: float = 0.0
        self.calls_by_kind: Dict[str, int] = {}
        self.bytes_by_kind: Dict[str, float] = {}
        self._worker_ids: Dict[str, int] = {}
        self._worker_names: List[str] = []
        self._worker_calls = np.zeros((0,), np.int64)
        self._kind_ids: Dict[str, int] = {}
        self._kind_names: List[str] = []
        # full chunks (immutable once flushed) + the current write buffer
        self._full_t: List[np.ndarray] = []
        self._full_w: List[np.ndarray] = []
        self._full_k: List[np.ndarray] = []
        self._full_nb: List[np.ndarray] = []
        self._buf_t = np.empty((self._CHUNK,), np.float64)
        self._buf_w = np.empty((self._CHUNK,), np.int32)
        self._buf_k = np.empty((self._CHUNK,), np.int32)
        self._buf_nb = np.empty((self._CHUNK,), np.float64)
        self._fill = 0

    # -- id registries ------------------------------------------------------
    def worker_id(self, worker: str) -> int:
        wid = self._worker_ids.get(worker)
        if wid is None:
            wid = len(self._worker_names)
            self._worker_ids[worker] = wid
            self._worker_names.append(worker)
            if wid >= self._worker_calls.shape[0]:
                grown = np.zeros((max(16, 2 * (wid + 1)),), np.int64)
                grown[:self._worker_calls.shape[0]] = self._worker_calls
                self._worker_calls = grown
        return wid

    def worker_ids(self, workers) -> np.ndarray:
        return np.asarray([self.worker_id(w) for w in workers], np.int32)

    def _kind_id(self, kind: str) -> int:
        kid = self._kind_ids.get(kind)
        if kid is None:
            kid = len(self._kind_names)
            self._kind_ids[kind] = kid
            self._kind_names.append(kind)
        return kid

    # -- event columns ------------------------------------------------------
    @property
    def _n_events(self) -> int:
        return len(self._full_t) * self._CHUNK + self._fill

    def _flush(self):
        self._full_t.append(self._buf_t)
        self._full_w.append(self._buf_w)
        self._full_k.append(self._buf_k)
        self._full_nb.append(self._buf_nb)
        self._buf_t = np.empty((self._CHUNK,), np.float64)
        self._buf_w = np.empty((self._CHUNK,), np.int32)
        self._buf_k = np.empty((self._CHUNK,), np.int32)
        self._buf_nb = np.empty((self._CHUNK,), np.float64)
        self._fill = 0

    def _append_cols(self, t: np.ndarray, wid: np.ndarray, kid: int,
                     nb: np.ndarray):
        m = t.shape[0]
        pos = 0
        while pos < m:
            take = min(self._CHUNK - self._fill, m - pos)
            s = slice(self._fill, self._fill + take)
            self._buf_t[s] = t[pos:pos + take]
            self._buf_w[s] = wid[pos:pos + take]
            self._buf_k[s] = kid
            self._buf_nb[s] = nb[pos:pos + take]
            self._fill += take
            pos += take
            if self._fill == self._CHUNK:
                self._flush()

    # -- accounting ---------------------------------------------------------
    def call(self, worker: str, kind: str, nbytes: float = 0.0, n: int = 1,
             t: Optional[float] = None):
        wid = self.worker_id(worker)
        self._worker_calls[wid] += n
        self.calls_by_kind[kind] = self.calls_by_kind.get(kind, 0) + n
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + nbytes
        self.bytes += nbytes
        kid = self._kind_id(kind)
        self._buf_t[self._fill] = np.nan if t is None else float(t)
        self._buf_w[self._fill] = wid
        self._buf_k[self._fill] = kid
        self._buf_nb[self._fill] = float(nbytes)
        self._fill += 1
        if self._fill == self._CHUNK:
            self._flush()

    def call_batch(self, wids: np.ndarray, kind: str, nbytes: np.ndarray,
                   t: np.ndarray, n_per: int = 1):
        """Bulk-record one event per entry of ``wids`` (worker ids from
        :meth:`worker_ids`), all of the same ``kind``.  ``nbytes``/``t``
        broadcast against ``wids``.  Aggregate counters and the event
        columns update in O(batch) numpy ops."""
        wids = np.asarray(wids, np.int32)
        m = wids.shape[0]
        if m == 0:
            return
        nb = np.broadcast_to(np.asarray(nbytes, np.float64), (m,))
        tt = np.broadcast_to(np.asarray(t, np.float64), (m,))
        np.add.at(self._worker_calls, wids, n_per)
        self.calls_by_kind[kind] = (self.calls_by_kind.get(kind, 0)
                                    + n_per * m)
        tot = float(nb.sum())
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + tot
        self.bytes += tot
        self._append_cols(tt, wids, self._kind_id(kind), nb)

    @property
    def api_calls(self) -> Dict[str, int]:
        """Per-worker PS-contact counts, materialized from the id-indexed
        column (kept a dict for API compatibility)."""
        return {name: int(self._worker_calls[i])
                for i, name in enumerate(self._worker_names)}

    @property
    def events(self) -> MeterEvents:
        return MeterEvents(self)

    @property
    def total_calls(self) -> int:
        return int(self._worker_calls[:len(self._worker_names)].sum())


# ---------------------------------------------------------------------------
# Model bundle: what the simulator trains
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ModelBundle:
    """The model's functions and its data: everything the cluster needs to
    train.  ``init(gen, device)`` draws the parameters from a
    ``torch.Generator``; ``loss`` / ``accuracy`` take ``(params, batch)``,
    a batch a dict of tensors; the data are host numpy arrays."""

    init: Callable[[torch.Generator, Any], Tree]
    loss: Callable[[Tree, Dict], torch.Tensor]
    accuracy: Callable[[Tree, Dict], torch.Tensor]
    train_data: Dict[str, np.ndarray]
    test_data: Dict[str, np.ndarray]
    eta: float = 0.1
    momentum: float = 0.0
    eval_batch: int = 512

    def nbytes(self, params: Tree) -> float:
        return float(sum(x.numel() * x.element_size()
                         for x in tree_leaves(params)))


def _make_step(bundle: ModelBundle):
    """One SGD step, ``(params, mom, batch) -> (params, mom)``, written out
    as the reference's: ``mom = momentum * mom + g`` and ``p - eta * mom``
    with momentum, else ``p - eta * g``.  Returns new tensors; the inputs
    are not modified."""
    eta, momentum = bundle.eta, bundle.momentum

    def step(params, mom, batch):
        leaves, treedef = tree_flatten(params)
        xs = [p.detach().requires_grad_(True) for p in leaves]
        loss = bundle.loss(tree_unflatten(treedef, xs), batch)
        grads = torch.autograd.grad(loss, xs)
        with torch.no_grad():
            if momentum > 0.0:
                upd = [momentum * m + g
                       for m, g in zip(tree_leaves(mom), grads)]
                mom = tree_unflatten(treedef, upd)
            else:
                upd = grads
            new = [p - eta * u for p, u in zip(leaves, upd)]
        return tree_unflatten(treedef, new), mom

    return step


def _make_eval(bundle: ModelBundle):
    """``(loss, accuracy)`` of ``(params, batch)``, without autograd."""
    def loss(params, batch):
        with torch.no_grad():
            return bundle.loss(params, batch)

    def accuracy(params, batch):
        with torch.no_grad():
            return bundle.accuracy(params, batch)

    return loss, accuracy


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------

class EdgeWorker:
    """A single edge device: local model replica + data shard + GUP state.

    ``train`` is the training set as tensors on the run's device: each
    step gathers its batch there, at the indices the loader draws."""

    def __init__(self, spec: WorkerSpec, params: Tree, indices: np.ndarray,
                 alloc: Allocation, bundle: ModelBundle,
                 hermes_cfg: Optional[HermesConfig], seed: int,
                 train: Dict[str, torch.Tensor]):
        self.spec = spec
        self.params = params
        self.mom = tree_map(torch.zeros_like, params)
        self.alloc = alloc
        self.bundle = bundle
        self.train = train
        self.loader = ShardedLoader(bundle.train_data, alloc.mbs, seed=seed,
                                    indices=indices)
        self.gup: Optional[GUPState] = gup_init(hermes_cfg) if hermes_cfg \
            else None
        self.rng = np.random.default_rng(seed + 17)
        # counters
        self.iterations = 0
        self.model_pulls = 0
        self.clock = 0.0           # worker-local simulated time
        self.last_train_time = 0.0
        self.prefetched = True     # data for the next iteration already local

    # -- simulated timing ---------------------------------------------------
    def k_now(self) -> float:
        drift = 1.0 + self.spec.drift_per_sec * self.clock
        return self.spec.k_base * drift

    def sim_iteration_time(self, eval_n: int) -> float:
        steps = self.alloc.steps_per_iteration
        jit = float(np.exp(self.rng.normal(0.0, self.spec.jitter)))
        train = self.k_now() * steps * jit
        evalt = self.k_now() * 0.35 * max(1.0, eval_n / max(self.alloc.mbs, 1))
        return train + evalt

    # -- real compute ---------------------------------------------------------
    def next_batch(self) -> Dict[str, torch.Tensor]:
        """The loader's next batch, gathered from the device-resident set."""
        dev = next(iter(self.train.values())).device
        idx = torch.from_numpy(self.loader.next_indices()).to(dev)
        return {k: v[idx] for k, v in self.train.items()}

    def run_local_iteration(self, step_fn, eval_loss_fn, eval_batch) -> float:
        """Perform DSS/MBS real SGD steps; return the test loss (float)."""
        for _ in range(self.alloc.steps_per_iteration):
            self.params, self.mom = step_fn(self.params, self.mom,
                                            self.next_batch())
        self.iterations += 1
        return float(eval_loss_fn(self.params, eval_batch))

    def set_allocation(self, alloc: Allocation, indices: np.ndarray):
        self.alloc = alloc
        self.loader.set_batch(alloc.mbs)
        self.loader.set_indices(indices)

    def refresh(self, params: Tree):
        self.params = params
        self.model_pulls += 1

    def wi(self) -> float:
        return self.iterations / max(1, self.model_pulls)


def assign_shards(n_train: int, workers: List["EdgeWorker"],
                  rng: np.random.Generator) -> None:
    """(Re)assign each worker a random DSS-sized shard."""
    for w in workers:
        idx = rng.choice(n_train, size=min(w.alloc.dss, n_train), replace=False)
        w.loader.set_indices(np.sort(idx))
