"""Loss-based SGD at the PS (paper Algorithm 2, Eq. 5-6; the reference's
``core/loss_sgd.py`` on tensor trees).

The PS keeps the initial parameters ``w0`` and a global gradient-sum
``sigma`` (the paper's ς).  A worker pushes its gradient-sum ``G`` (the
sum of its local-SGD gradients measured from ``w0``).  The PS:

    w_temp   = w0 - eta * G          ; L_temp = testloss(w_temp)
    W1, W2   = 1/L, 1/L_temp         ; L = testloss of current global model
    merged   = (W1 * sigma + W2 * G) / (W1 + W2)
    w_global = w0 - eta * merged     ; L <- testloss(w_global) ; sigma <- merged

The merge is computed as the reference computes it, ``c1 * s + c2 * g``
with fp32 coefficients ``c = W / (W1 + W2)``, in plain tensor ops: the
``loss_weighted_update`` kernel computes another association,
``(W1 * s + W2 * g) / (W1 + W2)``, and is not used here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch

from repro_torch.utils.trees import tree_map

Tree = Any


def loss_weighted_merge(sigma: Tree, G: Tree, L: float, L_temp: float
                        ) -> Tree:
    """(W1*sigma + W2*G)/(W1+W2) with W = 1/loss (Eq. 5-6)."""
    one, tiny = np.float32(1.0), np.float32(1e-12)
    w1 = one / np.maximum(np.float32(L), tiny)
    w2 = one / np.maximum(np.float32(L_temp), tiny)
    c1, c2 = float(w1 / (w1 + w2)), float(w2 / (w1 + w2))
    return tree_map(lambda s, g: c1 * s + c2 * g, sigma, G)


def apply_global(w0: Tree, eta: float, grad_sum: Tree) -> Tree:
    """w = w0 - eta * grad_sum."""
    return tree_map(lambda w, g: w - eta * g, w0, grad_sum)


@dataclasses.dataclass
class PSState:
    w0: Tree                      # frozen initial parameters
    sigma: Tree                   # global gradient storage (ς)
    eta: float
    L: float = float("inf")       # test loss of the current global model
    initialized: bool = False
    updates: int = 0

    def global_params(self) -> Tree:
        return apply_global(self.w0, self.eta, self.sigma)


def ps_init(w0: Tree, eta: float) -> PSState:
    return PSState(w0=w0, sigma=tree_map(torch.zeros_like, w0), eta=eta)


def ps_push(ps: PSState, G: Tree, eval_loss: Callable[[Tree], float]
            ) -> Tuple[PSState, Tree, dict]:
    """Algorithm 2.  Returns (new PS state, w_global, metrics).

    ``eval_loss(params) -> float`` is the PS-side test loss on the
    held-out split; it is called once on the first push and twice after
    (w_temp and w_global), as in the paper.
    """
    if not ps.initialized:
        w1 = apply_global(ps.w0, ps.eta, G)
        L = float(eval_loss(w1))
        new = PSState(w0=ps.w0, sigma=G, eta=ps.eta, L=L, initialized=True,
                      updates=ps.updates + 1)
        return new, w1, {"L": L, "L_temp": L, "evals": 1}

    w_temp = apply_global(ps.w0, ps.eta, G)
    L_temp = float(eval_loss(w_temp))
    merged = loss_weighted_merge(ps.sigma, G, ps.L, L_temp)
    w_global = apply_global(ps.w0, ps.eta, merged)
    L = float(eval_loss(w_global))
    new = PSState(w0=ps.w0, sigma=merged, eta=ps.eta, L=L, initialized=True,
                  updates=ps.updates + 1)
    return new, w_global, {"L": L, "L_temp": L_temp, "evals": 2}
