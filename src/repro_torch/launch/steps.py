"""Step builders: train, prefill and decode (the reference's
``launch/steps.py``).

``make_*_setup`` returns a :class:`StepSetup`: the step function, the
shapes and dtypes of its arguments (``arg_specs``, the counterpart of the
reference's ``abstract_args``: built on the ``meta`` device, so nothing is
allocated), ``init_state(seed)``, which builds the persistent state on the
setup's device, and ``meta``.

* train: ``step_fn(state, batch) -> (state, loss)``, the state
  ``{"params", "opt", "step"}``, donated as the reference's jit donates
  it (``donate_argnums=(0,)``): the optimizer writes into the state's
  own tensors and the state comes back itself.  With ``cfg.dtype ==
  "bfloat16"`` the parameters are bf16 and the optimizer keeps fp32
  master weights (``opt_rules``: the reference's ZeRO-1 placement of
  that state on a mesh);
  ``parallel.microbatch > 1`` accumulates the gradient over that many
  slices of the batch, one backward each;
* prefill: ``step_fn(params, cache, batch) -> (logits, cache)``;
* decode: ``step_fn(params, cache, tokens, pos) -> (logits, cache)``.
  Serving holds the parameters in bf16 when ``cfg.dtype == "bfloat16"``
  (the reference's ``_serve_param_state``) and the cache is
  ``init_cache``'s, bf16; ``init_state`` returns ``(params, cache)``.

The batch is the reference's ``input_specs``: ``tokens`` (and
``targets`` to train) of ``(B, S)``; the encoder-decoder adds ``frames
(B, S, d)`` in the compute dtype, and its cache holds the cross keys and
values of ``S`` encoder positions to prefill, ``min(4096, S)`` to
decode; a vision model takes ``F = min(frontend_tokens, S // 2) or S //
8`` positions of ``frontend_embeds (B, F, d)`` and ``S - F`` tokens.

:func:`abstract_init_lm` gives the parameter tree on the ``meta``
device with its logical axes (``models.lm.param_axes``), as the
reference's does without allocating; the axes feed
``dist.sharding``'s rules and the byte bill's ``block_axis`` hint.  The
reference also derives sharding trees for its mesh from those axes; one
card has no mesh to shard over, so the step builders take none, and the
MoE dispatch takes one token group (``_moe_groups`` is 1).  Tokens are
int64, the index type of the port's embedding.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.config import (
    ModelConfig, OptimizerConfig, ParallelConfig, ShapeConfig,
)
from repro_torch.dist.sharding import AxisRules
from repro_torch.models import lm as LM
from repro_torch.models.layers import compute_dtype
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.utils.trees import tree_flatten, tree_map, tree_unflatten

Tree = Any
META = torch.device("meta")


class Spec(NamedTuple):
    """The shape and dtype of one argument leaf."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass
class StepSetup:
    step_fn: Callable
    arg_specs: Tuple            # a tree of Spec per positional argument
    init_state: Callable[[int], Any]
    meta: Dict[str, Any]


def specs(tree: Tree) -> Tree:
    """A tree of :class:`Spec`, a Python int (a step count) as an int32
    scalar."""
    return tree_map(lambda x: Spec((), torch.int32) if isinstance(x, int)
                    else Spec(tuple(x.shape), x.dtype), tree)


def abstract_init_lm(cfg: ModelConfig) -> Tuple[Tree, Tree]:
    """``(params, param_axes)``: ``init_lm``'s tree on the ``meta``
    device (shapes and dtypes, nothing allocated or drawn) and the axes
    twin of its leaves."""
    return LM.init_lm(cfg, 0, META), LM.param_axes(cfg)


def opt_rules(rules: AxisRules, parallel: ParallelConfig) -> AxisRules:
    """ZeRO-1 (the reference's ``_opt_rules``): the optimizer state also
    shards "qkv" and "embed" over "data" where nothing else claims them;
    the rules as they are under FSDP or without ``zero1``."""
    if not parallel.zero1 or parallel.fsdp:
        return rules
    r = dict(rules.rules)
    for k in ("qkv", "embed"):
        if r.get(k) is None:
            r[k] = "data"
    return dataclasses.replace(rules, rules=r)


def _param_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _init_params(cfg: ModelConfig, seed: int, dev: torch.device):
    """The parameters in the step's dtype, drawn on ``dev`` (a card draws
    its own, so a model of billions never sits on the host)."""
    return LM.init_lm(cfg, seed, dev, draw_on=None if dev.type != "cuda"
                      else dev, dtype=_param_dtype(cfg))


def _batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                 targets: bool) -> Dict[str, Spec]:
    """The reference's ``input_specs`` for a train or prefill batch (its
    ``targets`` only with ``targets``)."""
    B, S = shape.global_batch, shape.seq_len
    dt = compute_dtype(cfg)
    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = Spec((B, S, cfg.d_model), dt)
    elif cfg.frontend != "none":
        F = min(cfg.frontend_tokens, S // 2) or S // 8
        out["frontend_embeds"] = Spec((B, F, cfg.d_model), dt)
        S -= F
    out["tokens"] = Spec((B, S), torch.int64)
    if targets:
        out["targets"] = Spec((B, S), torch.int64)
    return out


def _leaf_params(params: Tree) -> Tree:
    """Leaf copies of the parameters that collect gradients."""
    return tree_map(lambda x: x.detach().requires_grad_(True), params)


def make_train_setup(cfg: ModelConfig, shape: ShapeConfig,
                     parallel: ParallelConfig, opt_cfg: OptimizerConfig, *,
                     impl: str = "blocked", moe_impl: str = "sorted",
                     seed: int = 0, device="cuda") -> StepSetup:
    dev = resolve_device(device)
    optimizer = make_optimizer(opt_cfg, master_weights=(
        cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"))
    mb = max(1, parallel.microbatch)

    def build(seed: int, on: torch.device):
        params = _init_params(cfg, seed, on)
        return {"params": params, "opt": optimizer.init(params), "step": 0}

    def train_step(state, batch):
        params = _leaf_params(state["params"])
        leaves, _ = tree_flatten(params)
        kw = dict(impl=impl, moe_impl=moe_impl)
        if mb <= 1:
            loss = LM.lm_loss(params, batch, cfg, **kw)
            grads = torch.autograd.grad(loss, leaves)
        else:
            # gradient accumulation: one backward a microbatch, so the
            # activations held shrink by 1/mb; the loss is the mean
            split = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
                     for k, v in batch.items()}
            loss, grads = 0.0, None
            for i in range(mb):
                li = LM.lm_loss(params, {k: v[i] for k, v in split.items()},
                                cfg, **kw) / mb
                gi = torch.autograd.grad(li, leaves)
                grads = gi if grads is None else tuple(
                    a + b for a, b in zip(grads, gi))
                loss = loss + li.detach()
        _, treedef = tree_flatten(state["params"])
        with torch.no_grad():
            optimizer.apply_(state["params"],
                             tree_unflatten(treedef, list(grads)),
                             state["opt"])
        state["step"] += 1
        return state, loss.detach()

    return StepSetup(
        step_fn=train_step,
        arg_specs=(specs(build(seed, META)),
                   _batch_specs(cfg, shape, True)),
        init_state=lambda seed=seed: build(seed, dev),
        meta={"optimizer": optimizer, "microbatch": mb})


def _serve_state(cfg: ModelConfig, shape: ShapeConfig, dev: torch.device,
                 seed: int, enc_len: int):
    """``(params, cache)``: the parameters in bf16 when the model computes
    in bf16, and ``init_cache``'s cache of ``seq_len`` slots (and
    ``enc_len`` cross positions for the encoder-decoder)."""
    return (_init_params(cfg, seed, dev),
            LM.init_cache(cfg, shape.global_batch, shape.seq_len,
                          enc_len=enc_len if cfg.is_encoder_decoder else 0,
                          device=dev))


def make_prefill_setup(cfg: ModelConfig, shape: ShapeConfig, *,
                       impl: str = "blocked", moe_impl: str = "sorted",
                       seed: int = 0, device="cuda") -> StepSetup:
    dev = resolve_device(device)

    def prefill(params, cache, batch):
        with torch.no_grad():
            return LM.prefill_step(params, cache, batch, cfg, impl=impl,
                                   moe_impl=moe_impl)

    enc_len = shape.seq_len
    params, cache = _serve_state(cfg, shape, META, seed, enc_len)
    return StepSetup(
        step_fn=prefill,
        arg_specs=(specs(params), specs(cache),
                   _batch_specs(cfg, shape, False)),
        init_state=lambda seed=seed: _serve_state(cfg, shape, dev, seed,
                                                  enc_len),
        meta={})


def make_decode_setup(cfg: ModelConfig, shape: ShapeConfig, *,
                      impl: str = "auto", moe_impl: str = "sorted",
                      seed: int = 0, device="cuda") -> StepSetup:
    dev = resolve_device(device)

    def decode(params, cache, tokens, pos):
        with torch.no_grad():
            return LM.decode_step(params, cache, tokens, int(pos), cfg,
                                  impl=impl, moe_impl=moe_impl)

    enc_len = min(4096, shape.seq_len)
    params, cache = _serve_state(cfg, shape, META, seed, enc_len)
    return StepSetup(
        step_fn=decode,
        arg_specs=(specs(params), specs(cache),
                   Spec((shape.global_batch, 1), torch.int64),
                   Spec((), torch.int32)),
        init_state=lambda seed=seed: _serve_state(cfg, shape, dev, seed,
                                                  enc_len),
        meta={})


def build_setup(kind: str, cfg: ModelConfig, shape: ShapeConfig,
                parallel: Optional[ParallelConfig] = None,
                opt_cfg: Optional[OptimizerConfig] = None,
                **kw) -> StepSetup:
    if kind == "train":
        return make_train_setup(cfg, shape, parallel or ParallelConfig(),
                                opt_cfg or OptimizerConfig(), **kw)
    if kind == "prefill":
        return make_prefill_setup(cfg, shape, **kw)
    if kind == "decode":
        return make_decode_setup(cfg, shape, **kw)
    raise KeyError(kind)
