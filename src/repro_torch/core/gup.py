"""HermesGUP (paper Algorithm 1), the device-resident gate batched over pods.

The counterpart of the reference's ``core/gup.py:gup_state_jax`` /
``gup_gate_jax`` with a leading pod axis written out (the reference vmaps
it).  Each pod keeps a ring buffer of its last ``window`` eval losses and
pushes when ``z = (x - mean) / std <= alpha``; ``std`` is the *population*
standard deviation (divide by n, like ``np.std``), and ``z`` is ``+inf``
below two samples or at zero spread.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import HermesConfig

State = Dict[str, torch.Tensor]


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
