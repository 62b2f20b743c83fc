"""SGD, SGD with momentum and AdamW as pure functions over parameter trees
(the reference's ``optim/optimizers.py``), with mixed-precision master
weights.

``init(params) -> state`` and ``apply(params, grads, state) -> (params,
state)``; with pod-stacked trees the update is elementwise, so one call
updates every pod exactly as the reference's vmapped update does.  The
optimizer state (``mom``, ``m``, ``v``) is fp32 whatever the parameters'
dtype.  AdamW computes its update in fp32 and casts it back; SGD's step
``p - lr * u`` runs in the parameters' dtype, as the reference's does.  With
``master_weights=True`` the parameters stay in their compute dtype (bf16)
while fp32 copies live in the state as ``master``: the update applies to
them and the parameters are their cast.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.utils.trees import tree_leaves, tree_map

Tree = Any
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    apply: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]
    name: str


def _clip(grads: Tree, max_norm: float) -> Tree:
    if max_norm <= 0:
        return grads
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def _descend(p: torch.Tensor, lr: float, u: torch.Tensor) -> torch.Tensor:
    """``p - lr * u`` in p's dtype: ``lr`` and ``u`` rounded to it and each
    operation rounded, as the reference's (JAX takes a Python ``lr`` at a
    bf16 array's type)."""
    if p.dtype == F32:
        return p - lr * u.to(F32)
    return p - torch.tensor(lr, dtype=p.dtype, device=p.device) \
        * u.to(p.dtype)


def _f32(tree: Tree) -> Tree:
    return tree_map(lambda x: x.to(F32), tree)


def _zeros32(tree: Tree) -> Tree:
    return tree_map(lambda x: torch.zeros(x.shape, dtype=F32,
                                          device=x.device), tree)


def make_optimizer(cfg: OptimizerConfig, *, master_weights: bool = False
                   ) -> Optimizer:
    lr = cfg.lr

    def start(state, params):
        if master_weights:
            state["master"] = _f32(params)
        return state

    def finish(new, params, state):
        """``(params, state)`` from the updated ``new`` tree: with master
        weights ``new`` is the fp32 master and the params its cast."""
        if master_weights:
            state["master"] = new
            new = tree_map(lambda m, p: m.to(p.dtype), new, params)
        return new, state

    if cfg.name == "sgd" and cfg.momentum == 0.0:
        def init(params):
            return start({"step": 0}, params)

        def apply(params, grads, state):
            grads = _clip(grads, cfg.grad_clip)
            base = state["master"] if master_weights else params
            new = tree_map(lambda p, g: _descend(p, lr, g), base, grads)
            return finish(new, params, {"step": state["step"] + 1})

        return Optimizer(init, apply, "sgd")

    if cfg.name in ("sgd", "sgdm"):
        mu = cfg.momentum or 0.9

        def init(params):
            return start({"step": 0, "mom": _zeros32(params)}, params)

        def apply(params, grads, state):
            grads = _clip(grads, cfg.grad_clip)
            mom = tree_map(lambda m, g: mu * m + g.to(F32), state["mom"],
                           grads)
            base = state["master"] if master_weights else params
            new = tree_map(lambda p, m: _descend(p, lr, m), base, mom)
            return finish(new, params, {"step": state["step"] + 1,
                                        "mom": mom})

        return Optimizer(init, apply, "sgdm")

    if cfg.name == "adamw":
        b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay

        def init(params):
            return start({"step": 0, "m": _zeros32(params),
                          "v": _zeros32(params)}, params)

        def apply(params, grads, state):
            grads = _clip(grads, cfg.grad_clip)
            step = state["step"] + 1
            tf = torch.tensor(float(step), dtype=F32)
            # fp32 bias corrections, as the reference computes them
            c1 = (1.0 - torch.pow(torch.tensor(b1, dtype=F32), tf))
            c2 = (1.0 - torch.pow(torch.tensor(b2, dtype=F32), tf))
            m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(F32),
                         state["m"], grads)
            v = tree_map(lambda v_, g: b2 * v_ + (1 - b2)
                         * torch.square(g.to(F32)), state["v"], grads)
            base = state["master"] if master_weights else params

            def upd(p, m_, v_):
                c1d, c2d = c1.to(p.device), c2.to(p.device)
                pf = p.to(F32)
                step_ = (m_ / c1d) / (torch.sqrt(v_ / c2d) + eps) + wd * pf
                return (pf - lr * step_).to(p.dtype)

            new = tree_map(upd, base, m, v)
            return finish(new, params, {"step": step, "m": m, "v": v})

        return Optimizer(init, apply, "adamw")

    raise KeyError(f"optimizer {cfg.name!r} (want sgd, sgdm, adamw)")
