"""End-to-end LM training driver (the reference's ``launch/train.py``).

Two modes:

* ``single`` (the default): one model replica, AdamW, with checkpoints
  every 100 steps and at the end, and ``--restore`` from the latest one.
* ``hermes``: the Level-B trainer.  N pod replicas of the LM train
  locally on disjoint shards of one synthetic token stream.  Every
  ``lam`` steps (and after the first) each pod's eval loss feeds the GUP
  gate, admission trims the open gates to the participation budget, and
  the admitted pods merge into the global model through the wire format
  and restart from it.  With ``async_rounds`` a round's merge lands at
  the next round boundary (``hermes_dispatch`` then, one round later,
  ``hermes_commit``).  With ``--clusters N`` the pods form N clusters and
  every round is two-tier: each cluster merges its members' pushes into
  one partial and only the partials cross the slow tier.  All pods are
  stacked on one device, the reference's ``mesh=None`` layout, unless
  ``train_hermes`` is handed the process groups of a placed run.

Usage:
    python -m repro_torch.launch.train --preset lm100m --steps 300
    python -m repro_torch.launch.train --preset lmtiny --device cpu \
        --steps 10 --ckpt /tmp/ck     # then --steps 20 --restore
    python -m repro_torch.launch.train --preset lm100m --hermes --pods 4
    python -m repro_torch.launch.train --preset lm100m --hermes --pods 4 \
        --compression int8 --async-rounds
    python -m repro_torch.launch.train --preset lm100m --hermes --pods 4 \
        --participation-rate 0.5 --admission prob
    python -m repro_torch.launch.train --preset lm100m --hermes --pods 4 \
        --clusters 2 [--async-rounds]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import from_numpy
from repro_torch.checkpoint import Checkpointer
from repro_torch.config import (
    FAMILY_DENSE, HermesConfig, ModelConfig, OptimizerConfig,
)
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import make_batches, make_lm_dataset
from repro_torch.dist.hermes_sync import (
    hermes_cluster_commit, hermes_cluster_dispatch, hermes_cluster_round,
    hermes_pod_state, pending_merges,
)
from repro_torch.dist.wire import GeneratorNoise, NoiseFn, all_gather_rows
from repro_torch.launch.mesh import PodGroups, placed
from repro_torch.models.lm import init_lm, lm_loss
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.utils.trees import tree_flatten, tree_map, tree_unflatten

Tree = Any


def _preset(name: str) -> ModelConfig:
    """The reference's ``_preset``: the two Level-B LMs (fp32), else the
    smoke configuration of a ported architecture."""
    if name == "lm100m":
        return ModelConfig(
            name="lm100m", family=FAMILY_DENSE, num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32000,
            qk_norm=True, remat=False, dtype="float32")
    if name == "lmtiny":
        return ModelConfig(
            name="lmtiny", family=FAMILY_DENSE, num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
            remat=False, dtype="float32")
    return get_smoke_config(name)


def _host_fetch(values):
    """The round loop's one device-to-host read (the reference's
    ``_host_fetch``): a tuple of tensors copied to the host.  The loop
    calls it only at log steps and once after the loop, never per round,
    so the host keeps the card's queue full; ``analysis.hostsync``
    allows no other host read in the loop."""
    return tuple(v.detach().cpu() for v in values)


class _PhaseClock:
    """Sums the time of one phase of the loop without a host sync: on the
    card a pair of CUDA events around each span, read after the loop; on
    the CPU the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans: List = []
        self.host_s = 0.0

    def start(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def stop(self, started) -> None:
        if not self.cuda:
            self.host_s += time.perf_counter() - started
            return
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.spans.append((started, event))

    def seconds(self) -> float:
        """The summed spans; on the card this waits for the last one."""
        if not self.spans:
            return self.host_s
        self.spans[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in self.spans) / 1e3


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host batch onto ``device``: from pinned memory without blocking
    on the card (a pageable copy waits for the stream)."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _start(device) -> torch.device:
    """The entry points' device; on the card, TF32 off for the fp32
    presets, in every matmul and conv."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def _init_params(cfg: ModelConfig, seed: int, dev: torch.device,
                 params0: Optional[Tree]) -> Tree:
    """The port's own init, or ``params0`` (numpy arrays) on ``dev``."""
    return init_lm(cfg, seed, dev) if params0 is None \
        else from_numpy(params0, dev)


def _loss_and_grads(params: Tree, batch: Dict[str, torch.Tensor],
                    cfg: ModelConfig):
    """``(loss, grads)`` of one replica; the loss detached."""
    leaves, treedef = tree_flatten(params)
    mine = [x.detach().requires_grad_(True) for x in leaves]
    loss = lm_loss(tree_unflatten(treedef, mine), batch, cfg)
    grads = torch.autograd.grad(loss, mine)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def make_single_step(cfg: ModelConfig, optimizer, *, donate: bool = True
                     ) -> Callable:
    """The single trainer's step (the reference's ``step_fn``, jitted with
    ``donate_argnums=(0,)``): ``step(state, batch) -> (state, loss)`` on
    ``{"params", "opt", "step"}``.  Donated, AdamW writes into the
    state's own tensors and the state comes back itself: the old state is
    dead once the step returns.  ``donate=False`` is its functional twin,
    a new state a step."""
    def step(state, batch):
        loss, grads = _loss_and_grads(state["params"], batch, cfg)
        with torch.no_grad():
            if donate:
                optimizer.apply_(state["params"], grads, state["opt"])
                state["step"] += 1
                return state, loss
            p, o = optimizer.apply(state["params"], grads, state["opt"])
        return {"params": p, "opt": o, "step": state["step"] + 1}, loss

    return step


def _pod_losses_and_grads(pod_params: Tree, stacked: Dict[str, torch.Tensor],
                          cfg: ModelConfig):
    """Each pod's loss and gradient, a pod at a time, restacked."""
    leaves, treedef = tree_flatten(pod_params)
    losses, grads = [], []
    for i in range(int(leaves[0].shape[0])):
        loss, g = _loss_and_grads(
            tree_unflatten(treedef, [x[i] for x in leaves]),
            {k: v[i] for k, v in stacked.items()}, cfg)
        grads.append(tree_flatten(g)[0])
        losses.append(loss)
    stacked_grads = [torch.stack([g[j] for g in grads])
                     for j in range(len(leaves))]
    return torch.stack(losses), tree_unflatten(treedef, stacked_grads)


def make_pod_step(cfg: ModelConfig, optimizer, *, donate: bool = True
                  ) -> Callable:
    """``train_hermes``'s pod step (the reference's ``pod_step``, jitted
    with ``donate_argnums=(0, 1)``): ``pod_step(pod_params, pod_opt,
    stacked) -> (pod_params, pod_opt, losses)``, every pod's forward and
    backward, then AdamW on the stacked trees.  Donated, the update is
    written into ``pod_params``' and ``pod_opt``'s own tensors, which come
    back themselves; ``donate=False`` is the functional twin."""
    def pod_step(pod_params, pod_opt, stacked):
        losses, grads = _pod_losses_and_grads(pod_params, stacked, cfg)
        with torch.no_grad():
            if donate:
                optimizer.apply_(pod_params, grads, pod_opt)
            else:
                pod_params, pod_opt = optimizer.apply(pod_params, grads,
                                                      pod_opt)
        return pod_params, pod_opt, losses

    return pod_step


def make_async_round_fns(hcfg: HermesConfig,
                         groups: Optional[PodGroups] = None):
    """The async round's two halves, ``(dispatch, commit)`` (the
    reference's ``make_async_round_jits``): one definition for
    ``train_hermes``, the analyzer and the tests.

    ``dispatch(pod_params, gup, pod_losses, w_global, L, error, *,
    round_step, noise)`` is ``hermes_cluster_dispatch``.  ``commit(
    pod_params, pending, w_global)`` is ``hermes_cluster_commit`` with
    ``pod_params`` and ``pending`` donated, as the reference donates them:
    the refreshed rows are written into ``pod_params``' own leaves, and
    ``pending`` is emptied, which frees its payload.  Both are dead after
    the call; a caller that needs them clones first.  At one cluster both
    halves call the flat ones verbatim."""
    def dispatch(pod_params, gup, pod_losses, w_global, L, error, *,
                 round_step: int, noise: Optional[NoiseFn]):
        return hermes_cluster_dispatch(
            pod_params, gup, pod_losses, w_global, L, hcfg, error=error,
            round_step=round_step, noise=noise, groups=groups)

    def commit(pod_params, pending, w_global):
        cm = hermes_cluster_commit(pod_params, pending, w_global, cfg=hcfg,
                                   groups=groups, in_place=True)
        pending.clear()
        return cm

    return dispatch, commit


def train_single(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
                 opt_cfg: OptimizerConfig, ckpt_dir: Optional[str] = None,
                 restore: bool = False, log_every: int = 20, seed: int = 0,
                 device="cuda", params0: Optional[Tree] = None) -> Dict:
    """One replica, AdamW: the reference's ``train_single``.

    The state is ``{"params", "opt", "step"}``.  With ``ckpt_dir`` it is
    checkpointed every 100 steps and at ``steps`` (then waited for);
    ``restore`` resumes from the latest checkpoint there, with the data
    stream fast-forwarded past the batches already consumed.  A restore
    at or after ``steps`` runs no step and reports ``nan`` losses.
    ``params0`` (numpy arrays) replaces the port's own init.  Returns the
    reference's summary (final_loss: the mean of the last 10 losses,
    first_loss, steps) plus this run's ``losses`` and ``ms_per_step``
    (CUDA events on the card, the host clock on the CPU).  Its step
    (:func:`make_single_step`) updates the state in place.  The loop reads
    the device only at log steps, checkpoints and after the loop."""
    dev = _start(device)
    cfg.validate()
    rng = np.random.default_rng(seed)
    tokens = make_lm_dataset(batch * seq * 40 + 1, cfg.vocab_size, seed=seed)
    optimizer = make_optimizer(opt_cfg)
    params = _init_params(cfg, seed, dev, params0)
    state = {"params": params, "opt": optimizer.init(params), "step": 0}
    start_step = 0
    ck = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ck and restore:
        try:
            state, start_step = ck.restore(state, device=dev)
            print(f"restored from step {start_step}")
        except FileNotFoundError:
            pass
    # resume the data stream, don't replay already-consumed batches
    batches = make_batches(tokens, batch, seq, rng,
                           skip=min(start_step, steps))
    step_fn = make_single_step(cfg, optimizer)
    losses: List[torch.Tensor] = []
    clock = _PhaseClock(dev)
    t0 = time.time()
    for i in range(start_step, steps):
        b = {k: _to_device(v, dev) for k, v in next(batches).items()}
        started = clock.start()
        with torch.profiler.record_function("single/step"):
            state, loss = step_fn(state, b)
        clock.stop(started)
        losses.append(loss)
        if (i + 1) % log_every == 0:
            recent = [float(x) for x in _host_fetch(losses[-log_every:])]
            print(f"step {i + 1:5d} loss {np.mean(recent):.4f} "
                  f"({(i + 1 - start_step) / (time.time() - t0):.2f} it/s)",
                  flush=True)
        if ck and (i + 1) % 100 == 0:
            ck.save(state, i + 1)
    if ck:
        ck.save(state, steps)
        ck.wait()
    host = [float(x) for x in _host_fetch(losses)]
    # a restore at/after `steps` runs zero iterations; report nan
    return {"final_loss": float(np.mean(host[-10:])) if host
            else float("nan"),
            "first_loss": host[0] if host else float("nan"),
            "steps": steps, "losses": host,
            "ms_per_step": 1e3 * clock.seconds() / max(len(host), 1),
            "device": str(dev)}


def _all_pods(x: torch.Tensor, groups: Optional[PodGroups]) -> torch.Tensor:
    """Every pod's entry of a per-pod vector this rank holds its rows of
    (the vector itself unplaced)."""
    return all_gather_rows(x, *groups.group("pod")) if placed(groups) else x


def train_hermes(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
                 pods: int, opt_cfg: OptimizerConfig, hcfg: HermesConfig,
                 ckpt_dir: Optional[str] = None,
                 log_every: int = 20, seed: int = 0, device="cuda",
                 params0: Optional[Tree] = None,
                 noise: Optional[NoiseFn] = None,
                 groups: Optional[PodGroups] = None) -> Dict:
    """Pod-stacked local training + gated merges.

    ``params0`` (a parameter tree of numpy arrays) replaces the
    port's own init, so a test can start both frameworks from one model;
    ``noise`` replaces the int4 rounding noise and ``prob`` admission's
    draw (default: a :class:`GeneratorNoise` seeded with ``seed``).
    ``ckpt_dir`` is accepted and never read, as in the reference: the
    Hermes trainer writes no checkpoint.  Every round goes through the
    two-tier entry points (``hermes_cluster_round``, or ``_dispatch`` and
    ``_commit``), which call the flat round at ``hcfg.n_clusters == 1``.
    As in the reference, the pod step (:func:`make_pod_step`) and the
    async commit (:func:`make_async_round_fns`) donate: they update the
    pod parameters and the optimizer state in place.  Returns the
    reference's summary (global_loss, merges, rounds,
    pod_losses, history, and the async accounting async_rounds,
    dispatched, committed, drained; with async rounds ``merges`` counts
    commits) plus the time per step and per round: CUDA events on the
    card, the host clock on the CPU.

    ``groups`` (``launch.mesh.PodGroups``, ``groups.n_pods == pods``)
    places the run: this rank trains only its own pods, on data shards
    indexed by the global pod id, so a placed run sees the unplaced run's
    batches; every rank keeps and evaluates the global model.  The summary
    is the same on every rank but for the clocks, and rank 0 alone logs.

    As in the reference, the loop reads the device only through
    :func:`_host_fetch`, at log steps and after the loop: the counters and
    the per-round history stay on the device and are fetched once.  After
    a merge the global loss is re-evaluated on the round function's own
    host copy of its gate flag (``merged``; for async rounds, a payload
    pending), so the loop adds neither a sync nor an eval forward per
    round.  The round functions' own host reads stand in for the
    reference's ``lax.cond``.
    """
    dev = _start(device)
    hcfg.validate()
    cfg.validate()
    if groups is not None and groups.n_pods != pods:
        raise ValueError(f"groups place {groups.n_pods} pods, not {pods}")
    mine = groups.rows if placed(groups) else slice(0, pods)
    n_mine = mine.stop - mine.start
    tokens = make_lm_dataset(batch * seq * 40 * pods + batch * seq + 2,
                             cfg.vocab_size, seed=seed)
    # held-out eval split from the same stream (same Markov transitions)
    eval_tokens = tokens[-(batch * seq + 1):]
    shards = np.array_split(tokens[:-(batch * seq + 1)], pods)
    batch_iters = [make_batches(shards[i], batch, seq,
                                np.random.default_rng(seed + i))
                   for i in range(mine.start, mine.stop)]
    eval_batch = tree_map(
        lambda t: t.to(dev),
        next(make_batches(eval_tokens, min(batch, 8), seq,
                          np.random.default_rng(seed))))

    optimizer = make_optimizer(opt_cfg)
    w_global = _init_params(cfg, seed, dev, params0)
    pod_params = tree_map(
        lambda x: x[None].expand((n_mine,) + tuple(x.shape)).clone(),
        w_global)
    pod_opt = optimizer.init(pod_params)
    L_global = torch.tensor(1e9, dtype=torch.float32, device=dev)
    gup = hermes_pod_state(hcfg, n_mine, dev)
    error = None
    noise = noise if noise is not None else GeneratorNoise(seed, dev)
    logs = groups is None or groups.rank == 0

    pod_step = make_pod_step(cfg, optimizer)
    dispatch, commit_pending = make_async_round_fns(hcfg, groups)

    @torch.no_grad()
    def pod_eval(pod_params):
        leaves, treedef = tree_flatten(pod_params)
        return torch.stack([
            lm_loss(tree_unflatten(treedef, [x[i] for x in leaves]),
                    eval_batch, cfg) for i in range(n_mine)])

    @torch.no_grad()
    def eval_global(params):
        return lm_loss(params, eval_batch, cfg)

    def commit(pod_params, w_global, L_global, pending):
        """Merge the pending round; the global loss is re-evaluated only
        when it merged.  A dispatch encodes a payload only for an open
        gate (its own host read), so a pending payload is the host's flag.
        Returns the merge as a device int32 for the counters; the pods
        and ``pending`` are donated."""
        merged = pending_merges(pending)
        cm = commit_pending(pod_params, pending, w_global)
        if merged:
            L_global = eval_global(cm["w_global"])
        return (cm["pod_params"], cm["w_global"], L_global,
                cm["any_push"].to(torch.int32))

    rounds = 0
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    merges, dispatched, committed = zero, zero, zero  # device counters
    pending = None                # the in-flight round (async only)
    history: List = []            # (step, device mean loss, device gates)
    step_clock, round_clock = _PhaseClock(dev), _PhaseClock(dev)

    for i in range(steps):
        # As in the reference, each key draws its own batch, so "targets"
        # are not the shifted "tokens" of the same windows; kept for parity
        # (ROADMAP queue 3).
        stacked = {k: _to_device(torch.stack([next(b)[k]
                                              for b in batch_iters]), dev)
                   for k in ("tokens", "targets")}
        t0 = step_clock.start()
        # the named ranges are what a torch.profiler trace of a run reads
        with torch.profiler.record_function("hermes/pod_step"):
            pod_params, pod_opt, losses = pod_step(pod_params, pod_opt,
                                                   stacked)
        step_clock.stop(t0)
        if (i + 1) % hcfg.lam == 0 or i == 0:
            t0 = round_clock.start()
            rounds += 1
            with torch.profiler.record_function("hermes/round"), \
                    torch.no_grad():
                pod_losses = pod_eval(pod_params)
                if hcfg.async_rounds:
                    # commit round k-1's pending payload, then dispatch
                    # round k against the freshly merged global model
                    if pending is not None:
                        pod_params, w_global, L_global, opened = commit(
                            pod_params, w_global, L_global, pending)
                        pending = None  # frees the payload
                        merges = merges + opened
                        committed = committed + opened
                    out = dispatch(pod_params, gup, pod_losses, w_global,
                                   L_global, error, round_step=i,
                                   noise=noise)
                    pending = out["pending"]
                    dispatched = dispatched + out["any_push"].to(torch.int32)
                else:
                    out = hermes_cluster_round(
                        pod_params, gup, pod_losses, w_global, L_global,
                        hcfg, error=error, round_step=i, noise=noise,
                        groups=groups)
                    pod_params, w_global = out["pod_params"], out["w_global"]
                    if out["merged"]:  # re-evaluate after a merge
                        L_global = eval_global(w_global)
                    merges = merges + out["any_push"].to(torch.int32)
                gup, error = out["gup"], out["error"]
                history.append((i + 1, torch.mean(out["losses"]),
                                out["gates"].sum()))
            round_clock.stop(t0)
        if (i + 1) % log_every == 0:
            pod_l, gl_l, m = _host_fetch((_all_pods(losses, groups).mean(),
                                          L_global, merges))
            if logs:
                print(f"step {i + 1:5d} pod-loss {float(pod_l):.4f} "
                      f"global-L {float(gl_l):.4f} merges={int(m)}/{rounds}",
                      flush=True)
    # drain: the last dispatched payload has no following boundary, so it
    # is committed here; every open round merges exactly once
    if pending is not None:
        with torch.no_grad():
            pod_params, w_global, L_global, opened = commit(
                pod_params, w_global, L_global, pending)
        pending = None
        merges = merges + opened
        committed = committed + opened
    # one fetch: the per-round scalars are stacked on the device first
    hist_loss = torch.stack([l for _, l, _ in history]) if history \
        else torch.zeros((0,), device=dev)
    hist_gates = torch.stack([g for _, _, g in history]) if history \
        else torch.zeros((0,), dtype=torch.int64, device=dev)
    gl, pl, merges, dispatched, committed, hist_loss, hist_gates = \
        _host_fetch((eval_global(w_global),
                     _all_pods(pod_eval(pod_params), groups), merges,
                     dispatched, committed, hist_loss, hist_gates))
    pl = pl.tolist()
    merges = int(merges)
    return {"global_loss": float(gl), "merges": merges, "rounds": rounds,
            "pod_losses": pl, "best_pod_loss": min(pl),
            "history": [(s, l, g) for (s, _, _), l, g in zip(
                history, hist_loss.tolist(), hist_gates.tolist())],
            "steps": steps, "comm_fraction": merges / max(rounds, 1),
            "async_rounds": hcfg.async_rounds,
            "dispatched": int(dispatched), "committed": int(committed),
            "drained": pending is None,
            "ms_per_step": 1e3 * step_clock.seconds() / max(steps, 1),
            "ms_per_round": 1e3 * round_clock.seconds() / max(rounds, 1),
            "device": str(dev)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="lmtiny")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--hermes", action="store_true",
                    help="the Level-B Hermes trainer (default: one replica, "
                         "train_single)")
    ap.add_argument("--pods", type=int, default=4)
    ap.add_argument("--clusters", type=int, default=1,
                    help="two-tier Hermes: group the pods into N latency "
                         "clusters; the gated merge runs intra-cluster and "
                         "only each cluster's merged, re-encoded payload "
                         "crosses the slow tier (--pods must divide "
                         "evenly; 1 = flat round)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--alpha", type=float, default=-1.3)
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--lam", type=int, default=5)
    ap.add_argument("--compression", default=None,
                    help="wire format (none, fp16, int8, int4; default int4)")
    ap.add_argument("--async-rounds", action="store_true",
                    help="pipeline the rounds: dispatch a round's payload "
                         "and merge it at the next round boundary "
                         "(staleness 1)")
    ap.add_argument("--participation-rate", type=float, default=1.0,
                    help="admission budget on top of the z-gate: at most "
                         "max(1, floor(rate * n_open)) of the open gates "
                         "ship a round, the rest defer behind error "
                         "feedback; 1.0 = admission off")
    ap.add_argument("--admission", default="topk", choices=("topk", "prob"),
                    help="how the budget picks shippers: 'topk' by the "
                         "merge weight 1/loss, 'prob' i.i.d. Bernoulli "
                         "thinning")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (the single trainer)")
    ap.add_argument("--restore", action="store_true",
                    help="resume the single trainer from --ckpt's latest "
                         "checkpoint")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = _preset(args.preset)
    opt = OptimizerConfig(name="adamw", lr=args.lr)
    if args.hermes:
        kw = {} if args.compression is None else {
            "compression": args.compression}
        hcfg = HermesConfig(alpha=args.alpha, beta=args.beta, lam=args.lam,
                            eta=1.0, async_rounds=args.async_rounds,
                            n_clusters=args.clusters,
                            participation_rate=args.participation_rate,
                            admission=args.admission, **kw)
        hcfg.validate()
        if args.clusters > 1 and args.pods % args.clusters:
            ap.error(f"--pods {args.pods} must split evenly into "
                     f"--clusters {args.clusters}")
        out = train_hermes(cfg, steps=args.steps, batch=args.batch,
                           seq=args.seq, pods=args.pods, opt_cfg=opt,
                           hcfg=hcfg, ckpt_dir=args.ckpt, seed=args.seed,
                           device=args.device)
        out["compression"] = hcfg.compression
    else:
        out = train_single(cfg, steps=args.steps, batch=args.batch,
                           seq=args.seq, opt_cfg=opt, ckpt_dir=args.ckpt,
                           restore=args.restore, seed=args.seed,
                           device=args.device)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("history", "losses")}, indent=2))


if __name__ == "__main__":
    main()
