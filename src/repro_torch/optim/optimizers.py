"""SGD, SGD with momentum and AdamW as pure functions over parameter trees
(the reference's ``optim/optimizers.py``), with mixed-precision master
weights.

``init(params) -> state`` and ``apply(params, grads, state) -> (params,
state)``; with pod-stacked trees the update is elementwise, so one call
updates every pod exactly as the reference's vmapped update does.
``apply_`` is the same update donated, as the reference's jitted steps
donate their state: each leaf's new value is computed exactly as
``apply`` computes it, then copied into the parameter's and the state's
own tensors, a leaf at a time, so the update holds one leaf's
transients, not a second tree.  It returns ``params`` and ``state``
themselves.  The
optimizer state (``mom``, ``m``, ``v``) is fp32 whatever the parameters'
dtype.  AdamW computes its update in fp32 and casts it back; SGD's step
``p - lr * u`` runs in the parameters' dtype, as the reference's does.  With
``master_weights=True`` the parameters stay in their compute dtype (bf16)
while fp32 copies live in the state as ``master``: the update applies to
them and the parameters are their cast.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.utils.trees import (
    tree_flatten, tree_leaves, tree_map, tree_unflatten,
)

Tree = Any
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    apply: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]
    name: str
    apply_: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]


def _clip_scale(grads: Tree, max_norm: float) -> Optional[torch.Tensor]:
    """The global-norm clip's factor over the whole tree (None: no clip)."""
    if max_norm <= 0:
        return None
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in tree_leaves(grads)))
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def _clipped(g: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    return g if scale is None else g * scale


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


def _no_shared(step: int) -> dict:
    return {}


def _rule(leaf_update: Callable, keys: Tuple[str, ...], master: bool,
          clip: float, per_step: Callable[[int], dict]):
    """``(apply, apply_)`` of one update rule, the gradient clipped to the
    global norm ``clip`` over the whole tree first (0: no clip).
    ``leaf_update(p, g, *slots, **per_step(step)) -> (new p, *new
    slots)`` is the rule on one leaf (``p`` the fp32 master with master
    weights), its slots the state trees ``keys``; ``per_step`` computes
    what every leaf of a step shares.  Both halves run that one function
    on every leaf, so they agree bit for bit."""

    def leaves(params, grads, state):
        base = state["master"] if master else params
        flat, treedef = tree_flatten(base)
        rows = [tree_leaves(params), tree_leaves(grads)] + \
            [tree_leaves(state[k]) for k in keys]
        return treedef, flat, list(zip(*rows))

    def apply(params, grads, state):
        scale = _clip_scale(grads, clip)
        step = state["step"] + 1
        shared = per_step(step)
        treedef, base, rows = leaves(params, grads, state)
        outs = [leaf_update(b, _clipped(g, scale), *slots, **shared)
                for b, (_, g, *slots) in zip(base, rows)]
        new = tree_unflatten(treedef, [o[0] for o in outs])
        out_state = {"step": step}
        for j, k in enumerate(keys):
            out_state[k] = tree_unflatten(treedef, [o[1 + j] for o in outs])
        if master:
            out_state["master"] = new
            new = tree_map(lambda m, p: m.to(p.dtype), new, params)
        return new, out_state

    def apply_(params, grads, state):
        scale = _clip_scale(grads, clip)
        step = state["step"] + 1
        shared = per_step(step)
        _, base, rows = leaves(params, grads, state)
        for b, (p, g, *slots) in zip(base, rows):
            new, *news = leaf_update(b, _clipped(g, scale), *slots, **shared)
            for slot, x in zip(slots, news):
                slot.copy_(x)
            b.copy_(new)
            if master:
                p.copy_(new.to(p.dtype))
            del new, news
        state["step"] = step
        return params, state

    return apply, apply_


def make_optimizer(cfg: OptimizerConfig, *, master_weights: bool = False
                   ) -> Optimizer:
    lr = cfg.lr

    def build(name: str, leaf_update: Callable, keys: Tuple[str, ...],
              per_step: Callable[[int], dict] = _no_shared):
        def init(params):
            state = {"step": 0}
            state.update((k, _zeros32(params)) for k in keys)
            if master_weights:
                state["master"] = _f32(params)
            return state

        apply, apply_ = _rule(leaf_update, keys, master_weights,
                              cfg.grad_clip, per_step)
        return Optimizer(init, apply, name, apply_)

    if cfg.name == "sgd" and cfg.momentum == 0.0:
        def sgd(p, g):
            return (_descend(p, lr, g),)

        return build("sgd", sgd, ())

    if cfg.name in ("sgd", "sgdm"):
        mu = cfg.momentum or 0.9

        def sgdm(p, g, mom):
            mom = mu * mom + g.to(F32)
            return _descend(p, lr, mom), mom

        return build("sgdm", sgdm, ("mom",))

    if cfg.name == "adamw":
        b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay

        def adamw(p, g, m, v, c1, c2):
            m = b1 * m + (1 - b1) * g.to(F32)
            v = b2 * v + (1 - b2) * torch.square(g.to(F32))
            c1d, c2d = c1.to(p.device), c2.to(p.device)
            pf = p.to(F32)
            step_ = (m / c1d) / (torch.sqrt(v / c2d) + eps) + wd * pf
            return (pf - lr * step_).to(p.dtype), m, v

        def per_step(step):
            tf = torch.tensor(float(step), dtype=F32)
            # fp32 bias corrections, as the reference computes them
            return {"c1": 1.0 - torch.pow(torch.tensor(b1, dtype=F32), tf),
                    "c2": 1.0 - torch.pow(torch.tensor(b2, dtype=F32), tf)}

        return build("adamw", adamw, ("m", "v"), per_step)

    raise KeyError(f"optimizer {cfg.name!r} (want sgd, sgdm, adamw)")
