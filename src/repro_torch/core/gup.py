"""HermesGUP (paper Algorithm 1): the z-score gate on recent test losses.

A worker keeps its last ``window`` test losses and, after an iteration
with test loss ``x``, pushes iff ``z = (x - mean) / std <= alpha``;
``std`` is the *population* standard deviation (divide by n, like
``np.std``), and ``z`` is ``+inf`` below two samples or at zero spread.
After ``lam`` iterations without a push, ``alpha`` decays by ``beta``
toward ``alpha_max`` (more permissive), and it never falls below
``alpha_min``.

Two forms, as in the reference's ``core/gup.py``: the host gate of one
worker (``GUPState``, ``gup_init``, ``gup_update``; the Level-A
simulator), and the device-resident gate batched over pods
(``gup_gate``: ``gup_gate_jax`` with the pod axis written out, which the
reference vmaps; the Level-B trainer).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Tuple

import numpy as np
import torch

from repro_torch.config import HermesConfig

State = Dict[str, torch.Tensor]


@dataclasses.dataclass
class GUPState:
    cfg: HermesConfig
    queue: Deque[float]
    alpha: float
    n_iter: int = 0
    pushes: int = 0
    iterations: int = 0

    def snapshot(self) -> dict:
        return {"alpha": self.alpha, "n_iter": self.n_iter,
                "pushes": self.pushes, "iterations": self.iterations,
                "queue": list(self.queue)}


def gup_init(cfg: HermesConfig) -> GUPState:
    return GUPState(cfg=cfg, queue=deque(maxlen=cfg.window), alpha=cfg.alpha)


def zscore(queue, x: float) -> float:
    """z of x against the current queue; +inf when undefined (no variance)."""
    if len(queue) < 2:
        return float("inf")
    mu = float(np.mean(queue))
    sigma = float(np.std(queue))
    if sigma <= 1e-12:
        return float("inf")
    return (x - mu) / sigma


def gup_update(state: GUPState, test_loss: float) -> Tuple[bool, GUPState]:
    """Algorithm 1, one iteration of one worker.  Returns (push?, state);
    mutates ``state``."""
    cfg = state.cfg
    z = zscore(state.queue, test_loss)
    state.queue.append(test_loss)
    state.iterations += 1
    push = z <= state.alpha
    if push:
        state.n_iter = 0
        state.pushes += 1
    else:
        state.n_iter += 1
        if state.n_iter >= cfg.lam:
            state.alpha = min(state.alpha + cfg.beta, cfg.alpha_max)
            state.n_iter = 0
    state.alpha = max(state.alpha, cfg.alpha_min)
    return push, state


def gup_gate(state: State, test_loss: torch.Tensor, cfg: HermesConfig
             ) -> Tuple[torch.Tensor, State]:
    """One Algorithm-1 step for every pod.  ``test_loss``: (n_pods,) fp32.
    Returns ``(push (n_pods,) bool, new_state)``; the input is not mutated."""
    q, cnt = state["queue"], state["count"]
    w = cfg.window
    n_valid = torch.clamp(cnt, max=w)
    valid = torch.arange(w, device=q.device)[None, :] < n_valid[:, None]
    denom = torch.clamp(n_valid, min=1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    mu = torch.where(valid, q, zero).sum(dim=1) / denom
    var = torch.where(valid, torch.square(q - mu[:, None]), zero).sum(dim=1) \
        / denom
    sigma = torch.sqrt(var)
    x = test_loss.to(torch.float32)
    z = torch.where((n_valid >= 2) & (sigma > 1e-12),
                    (x - mu) / torch.clamp(sigma, min=1e-12),
                    torch.full_like(x, float("inf")))
    push = z <= state["alpha"]

    slot = torch.remainder(cnt, w).to(torch.int64)
    q = q.clone()
    q[torch.arange(q.shape[0], device=q.device), slot] = x
    n_iter = torch.where(push, torch.zeros_like(state["n_iter"]),
                         state["n_iter"] + 1)
    decay = (~push) & (n_iter >= cfg.lam)
    alpha = torch.where(decay,
                        torch.clamp(state["alpha"] + cfg.beta,
                                    max=cfg.alpha_max),
                        state["alpha"])
    alpha = torch.clamp(alpha, min=cfg.alpha_min)
    n_iter = torch.where(decay, torch.zeros_like(n_iter), n_iter)
    return push, {"queue": q, "count": cnt + 1, "alpha": alpha,
                  "n_iter": n_iter}
