"""Level-B Hermes trainer (the reference's ``launch/train.py``,
synchronous rounds).

N pod replicas of the LM train locally on disjoint shards of one synthetic
token stream.  Every ``lam`` steps (and after the first) each pod's eval
loss feeds the GUP gate, and the gate-open pods merge into the global model
through the wire format and restart from it.  All pods are stacked on one
device, the reference's ``mesh=None`` layout.

Usage:
    python -m repro_torch.launch.train --preset lm100m --hermes --pods 4
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
from repro_torch.data.synthetic import make_batches, make_lm_dataset
from repro_torch.dist.hermes_sync import hermes_pod_state, hermes_round
from repro_torch.dist.wire import GeneratorNoise, NoiseFn
from repro_torch.models.lm import init_lm, lm_loss
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.utils.trees import tree_flatten, tree_map, tree_unflatten

Tree = Any


def _preset(name: str) -> ModelConfig:
    if name == "lm100m":
        return ModelConfig(
            name="lm100m", family=FAMILY_DENSE, num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32000,
            qk_norm=True)
    if name == "lmtiny":
        return ModelConfig(
            name="lmtiny", family=FAMILY_DENSE, num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512)
    raise KeyError(f"unknown preset {name!r} (want lm100m or lmtiny)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    summary (global_loss, merges, rounds, pod_losses, history, ...) plus
    host-clock times per step and per round, each ending in a device
    synchronise.
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

    rounds, merges = 0, 0
    history: List = []
    step_s, round_s = 0.0, 0.0
    for i in range(steps):
        # As in the reference, each key draws its own batch, so "targets"
        # are not the shifted "tokens" of the same windows; kept for parity
        # (ROADMAP queue 3).
        stacked = {k: torch.stack([next(b)[k] for b in batch_iters]).to(dev)
                   for k in ("tokens", "targets")}
        t0 = time.perf_counter()
        # the named ranges are what a torch.profiler trace of a run reads
        with torch.profiler.record_function("hermes/pod_step"):
            losses, grads = pod_losses_and_grads(pod_params, stacked)
            with torch.no_grad():
                pod_params, pod_opt = optimizer.apply(pod_params, grads,
                                                      pod_opt)
            del grads
            _sync(dev)
        step_s += time.perf_counter() - t0
        if (i + 1) % hcfg.lam == 0 or i == 0:
            t0 = time.perf_counter()
            rounds += 1
            with torch.profiler.record_function("hermes/round"):
                pod_losses = pod_eval(pod_params)
                with torch.no_grad():
                    out = hermes_round(pod_params, gup, pod_losses, w_global,
                                       L_global, hcfg, error=error,
                                       round_step=i, noise=noise)
                pod_params, w_global = out["pod_params"], out["w_global"]
                gup, error = out["gup"], out["error"]
                if bool(out["any_push"]):  # re-evaluate only after a merge
                    merges += 1
                    L_global = eval_global(w_global)
                history.append((i + 1, float(torch.mean(pod_losses)),
                                int(out["gates"].sum())))
                _sync(dev)
            round_s += time.perf_counter() - t0
        if (i + 1) % log_every == 0:
            print(f"step {i + 1:5d} pod-loss {float(losses.mean()):.4f} "
                  f"global-L {float(L_global):.4f} merges={merges}/{rounds}",
                  flush=True)
    gl = float(eval_global(w_global))
    pl = [float(x) for x in pod_eval(pod_params)]
    return {"global_loss": gl, "merges": merges, "rounds": rounds,
            "pod_losses": pl, "best_pod_loss": min(pl), "history": history,
            "steps": steps, "comm_fraction": merges / max(rounds, 1),
            "ms_per_step": 1e3 * step_s / max(steps, 1),
            "ms_per_round": 1e3 * round_s / max(rounds, 1),
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
                    help="wire format (none, fp16, int4; default int4)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not args.hermes:
        ap.error("only --hermes training is ported")
    kw = {} if args.compression is None else {"compression": args.compression}
    hcfg = HermesConfig(alpha=args.alpha, beta=args.beta, lam=args.lam,
                        eta=1.0, **kw)
    out = train_hermes(_preset(args.preset), steps=args.steps,
                       batch=args.batch, seq=args.seq, pods=args.pods,
                       opt_cfg=OptimizerConfig(name="adamw", lr=args.lr),
                       hcfg=hcfg, seed=args.seed, device=args.device)
    out["compression"] = hcfg.compression
    print(json.dumps({k: v for k, v in out.items() if k != "history"},
                     indent=2))


if __name__ == "__main__":
    main()
