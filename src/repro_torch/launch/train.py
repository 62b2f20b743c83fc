"""Level-B Hermes trainer (the reference's ``launch/train.py``,
synchronous or async rounds).

N pod replicas of the LM train locally on disjoint shards of one synthetic
token stream.  Every ``lam`` steps (and after the first) each pod's eval
loss feeds the GUP gate, and the gate-open pods merge into the global model
through the wire format and restart from it.  With ``async_rounds`` a
round's merge lands at the next round boundary (``hermes_dispatch`` then,
one round later, ``hermes_commit``).  All pods are stacked on one device,
the reference's ``mesh=None`` layout.

Usage:
    python -m repro_torch.launch.train --preset lm100m --hermes --pods 4
    python -m repro_torch.launch.train --preset lm100m --hermes --pods 4 \
        --compression int8 --async-rounds
    python -m repro_torch.launch.train --preset lmtiny --hermes --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import from_numpy
from repro_torch.config import (
    FAMILY_DENSE, HermesConfig, ModelConfig, OptimizerConfig,
)
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import make_batches, make_lm_dataset
from repro_torch.dist.hermes_sync import (
    hermes_commit, hermes_dispatch, hermes_pod_state, hermes_round,
)
from repro_torch.dist.wire import GeneratorNoise, NoiseFn
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
            qk_norm=True, dtype="float32")
    if name == "lmtiny":
        return ModelConfig(
            name="lmtiny", family=FAMILY_DENSE, num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
            dtype="float32")
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


def train_hermes(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
                 pods: int, opt_cfg: OptimizerConfig, hcfg: HermesConfig,
                 log_every: int = 20, seed: int = 0, device="cuda",
                 params0: Optional[Tree] = None,
                 noise: Optional[NoiseFn] = None) -> Dict:
    """Pod-stacked local training + gated merges.

    ``params0`` (a parameter tree of numpy arrays) replaces the
    port's own init, so a test can start both frameworks from one model;
    ``noise`` replaces the int4 rounding noise (default: a
    :class:`GeneratorNoise` seeded with ``seed``).  Returns the reference's
    summary (global_loss, merges, rounds, pod_losses, history, and the
    async accounting async_rounds, dispatched, committed, drained; with
    async rounds ``merges`` counts commits) plus the time per step and per
    round: CUDA events on the card, the host clock on the CPU.

    As in the reference, the loop reads the device only through
    :func:`_host_fetch`, at log steps and after the loop: the counters and
    the per-round history stay on the device and are fetched once.  After
    a merge the global loss is re-evaluated on the round function's own
    host copy of its gate flag (``merged``; for async rounds, a payload
    pending), so the loop adds neither a sync nor an eval forward per
    round.  The round functions' own host reads stand in for the
    reference's ``lax.cond``.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the presets are fp32: keep TF32 out of every matmul and conv
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    hcfg.validate()
    cfg.validate()
    tokens = make_lm_dataset(batch * seq * 40 * pods + batch * seq + 2,
                             cfg.vocab_size, seed=seed)
    # held-out eval split from the same stream (same Markov transitions)
    eval_tokens = tokens[-(batch * seq + 1):]
    shards = np.array_split(tokens[:-(batch * seq + 1)], pods)
    batch_iters = [make_batches(s, batch, seq, np.random.default_rng(seed + i))
                   for i, s in enumerate(shards)]
    eval_batch = tree_map(
        lambda t: t.to(dev),
        next(make_batches(eval_tokens, min(batch, 8), seq,
                          np.random.default_rng(seed))))

    optimizer = make_optimizer(opt_cfg)
    if params0 is None:
        w_global = init_lm(cfg, seed, dev)
    else:
        w_global = from_numpy(params0, dev)
    pod_params = tree_map(
        lambda x: x[None].expand((pods,) + tuple(x.shape)).clone(), w_global)
    pod_opt = optimizer.init(pod_params)
    L_global = torch.tensor(1e9, dtype=torch.float32, device=dev)
    gup = hermes_pod_state(hcfg, pods, dev)
    error = None
    noise = noise if noise is not None else GeneratorNoise(seed, dev)

    def pod_losses_and_grads(pod_params, stacked):
        leaves, treedef = tree_flatten(pod_params)
        losses, grads = [], []
        for i in range(pods):
            mine = [x[i].detach().requires_grad_(True) for x in leaves]
            loss = lm_loss(tree_unflatten(treedef, mine),
                           {k: v[i] for k, v in stacked.items()}, cfg)
            grads.append(torch.autograd.grad(loss, mine))
            losses.append(loss.detach())
        stacked_grads = [torch.stack([g[j] for g in grads])
                         for j in range(len(leaves))]
        return torch.stack(losses), tree_unflatten(treedef, stacked_grads)

    @torch.no_grad()
    def pod_eval(pod_params):
        leaves, treedef = tree_flatten(pod_params)
        return torch.stack([
            lm_loss(tree_unflatten(treedef, [x[i] for x in leaves]),
                    eval_batch, cfg) for i in range(pods)])

    @torch.no_grad()
    def eval_global(params):
        return lm_loss(params, eval_batch, cfg)

    def commit(pod_params, w_global, L_global, pending):
        """Merge the pending round; the global loss is re-evaluated only
        when it merged.  A dispatch encodes a payload only for an open
        gate (its own host read), so a pending payload is the host's flag.
        Returns the merge as a device int32 for the counters."""
        cm = hermes_commit(pod_params, pending, w_global, cfg=hcfg)
        if pending["payload"] is not None:
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
            losses, grads = pod_losses_and_grads(pod_params, stacked)
            with torch.no_grad():
                pod_params, pod_opt = optimizer.apply(pod_params, grads,
                                                      pod_opt)
            del grads
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
                    out = hermes_dispatch(pod_params, gup, pod_losses,
                                          w_global, L_global, hcfg,
                                          error=error, round_step=i,
                                          noise=noise)
                    pending = out["pending"]
                    dispatched = dispatched + out["any_push"].to(torch.int32)
                else:
                    out = hermes_round(pod_params, gup, pod_losses, w_global,
                                       L_global, hcfg, error=error,
                                       round_step=i, noise=noise)
                    pod_params, w_global = out["pod_params"], out["w_global"]
                    if out["merged"]:  # re-evaluate after a merge
                        L_global = eval_global(w_global)
                    merges = merges + out["any_push"].to(torch.int32)
                gup, error = out["gup"], out["error"]
                history.append((i + 1, torch.mean(pod_losses),
                                out["gates"].sum()))
            round_clock.stop(t0)
        if (i + 1) % log_every == 0:
            pod_l, gl_l, m = _host_fetch((losses.mean(), L_global, merges))
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
        _host_fetch((eval_global(w_global), pod_eval(pod_params), merges,
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
                    help="required: only the Hermes trainer is ported")
    ap.add_argument("--pods", type=int, default=4)
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
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not args.hermes:
        ap.error("only --hermes training is ported")
    kw = {} if args.compression is None else {"compression": args.compression}
    hcfg = HermesConfig(alpha=args.alpha, beta=args.beta, lam=args.lam,
                        eta=1.0, async_rounds=args.async_rounds, **kw)
    out = train_hermes(_preset(args.preset), steps=args.steps,
                       batch=args.batch, seq=args.seq, pods=args.pods,
                       opt_cfg=OptimizerConfig(name="adamw", lr=args.lr),
                       hcfg=hcfg, seed=args.seed, device=args.device)
    out["compression"] = hcfg.compression
    print(json.dumps({k: v for k, v in out.items() if k != "history"},
                     indent=2))


if __name__ == "__main__":
    main()
