"""Plain SGD and AdamW as pure functions over parameter trees (the
reference's ``optim/optimizers.py``, fp32, no master weights).

``init(params) -> state`` and ``apply(params, grads, state) -> (params,
state)``; with pod-stacked trees the update is elementwise, so one call
updates every pod exactly as the reference's vmapped update does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.utils.trees import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    apply: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]
    name: str


def _clip(grads: Tree, max_norm: float) -> Tree:
    if max_norm <= 0:
        return grads
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    lr = cfg.lr
    if cfg.name == "sgd" and cfg.momentum == 0.0:
        def init(params):
            return {"step": 0}

        def apply(params, grads, state):
            grads = _clip(grads, cfg.grad_clip)
            new = tree_map(lambda p, g: p - lr * g, params, grads)
            return new, {"step": state["step"] + 1}

        return Optimizer(init, apply, "sgd")

    if cfg.name == "adamw":
        b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay

        def init(params):
            return {"step": 0, "m": tree_map(torch.zeros_like, params),
                    "v": tree_map(torch.zeros_like, params)}

        def apply(params, grads, state):
            grads = _clip(grads, cfg.grad_clip)
            step = state["step"] + 1
            tf = torch.tensor(float(step), dtype=torch.float32)
            # fp32 bias corrections, as the reference computes them
            c1 = (1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), tf))
            c2 = (1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), tf))
            m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"],
                         grads)
            v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g),
                         state["v"], grads)

            def upd(p, m_, v_):
                c1d, c2d = c1.to(p.device), c2.to(p.device)
                step_ = (m_ / c1d) / (torch.sqrt(v_ / c2d) + eps) + wd * p
                return p - lr * step_

            return tree_map(upd, params, m, v), {"step": step, "m": m, "v": v}

        return Optimizer(init, apply, "adamw")

    raise KeyError(f"optimizer {cfg.name!r} is not ported (sgd, adamw)")
