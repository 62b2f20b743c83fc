"""The synchronous Hermes round over pod-stacked trees (the reference's
``dist/hermes_sync.py``: ``hermes_pod_state``, ``admit_gates``,
``hermes_merge``, ``hermes_round``; unplaced, one cluster).

Trees are nested dicts of tensors; a pod-stacked tree carries a leading
``(n_pods,)`` axis on every leaf.  The merge is the paper's Algorithm 2 in
model space,

    w_global' = (W1 * w_global + sum_i W2_i * w_i) / (W1 + sum_i W2_i)

with ``W1 = 1/L(global)``, ``W2_i = 1/loss_i`` over the gate-open pods.
Gate-open pods push ``w_i - w_global`` through the wire format (with their
error-feedback residual folded in) and restart from the merged model.

Two merge associations, each pinned to its own reference path:

* kernels (``use_kernel``): int4 merges the packed payload into the global
  leaf with ``dequant_merge_packed`` (``denom*g + sum w2_i*(q_i*s_i)``),
  ``none``/``fp16`` use ``loss_weighted_update`` on the reconstructed pods;
* plain: the receiver decodes pod ``i``'s payload row and accumulates
  ``w2_i*(g + r_i)`` on ``w1*g`` (the reference's ``_merge_sliced``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.config import HermesConfig
from repro_torch.core.gup import gup_gate
from repro_torch.dist.compression import decode_tree, encode_tree
from repro_torch.dist.wire import (
    NoiseFn, block_axis, gather_payloads, get_format, resolve_kernel_dispatch,
)
from repro_torch.kernels import ops
from repro_torch.utils.trees import (
    flatten_up_to, tree_flatten, tree_map, tree_unflatten,
)

Tree = Any

_EPS = 1e-12  # loss -> weight guard


def hermes_pod_state(cfg: HermesConfig, n_pods: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """Initial pod-stacked gate state (queue, count, alpha, n_iter): every
    leaf has a leading (n_pods,)."""
    return {
        "queue": torch.zeros((n_pods, cfg.window), dtype=torch.float32,
                             device=device),
        "count": torch.zeros((n_pods,), dtype=torch.int32, device=device),
        "alpha": torch.full((n_pods,), cfg.alpha, dtype=torch.float32,
                            device=device),
        "n_iter": torch.zeros((n_pods,), dtype=torch.int32, device=device),
    }


def _pod_mask(gates: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """(n,) gates shaped to broadcast against a (n, ...) stacked leaf."""
    return gates.reshape(gates.shape + (1,) * (leaf.ndim - 1))


def admit_gates(gates: torch.Tensor, losses: torch.Tensor,
                cfg: HermesConfig) -> torch.Tensor:
    """Participation-rate admission on top of the z-score gate: keep at most
    ``max(1, floor(participation_rate * n_open))`` of the open gates, the
    ones with the largest merge weight ``1/loss`` (stable sort, ties to the
    lower pod index).  ``participation_rate >= 1`` returns ``gates``."""
    prate = float(cfg.participation_rate)
    if prate >= 1.0:
        return gates
    if cfg.admission != "topk":
        raise NotImplementedError(
            f"admission={cfg.admission!r} is not ported yet (topk is)")
    gates = gates.to(torch.bool)
    n_open = int(gates.sum())  # host read: the admission budget
    w2 = torch.where(gates,
                     1.0 / torch.clamp(losses.to(torch.float32), min=_EPS),
                     torch.full_like(losses, -math.inf, dtype=torch.float32))
    order = torch.argsort(-w2, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    k = max(1, math.floor(prate * n_open)) if n_open > 0 else 0
    return gates & (rank < k)


def _merge_leaf(g, pods, w1, w2, denom, any_push):
    """Plain ``(w1*g + sum_i w2_i*pods_i)/denom``, else ``g`` (the
    reference's ``_merge_leaf_jnp``, the decode-fallback merge)."""
    gf = g.to(torch.float32)
    acc = w1 * gf
    for i in range(pods.shape[0]):
        acc = acc + w2[i] * pods[i].to(torch.float32)
    return torch.where(any_push, acc / denom, gf).to(g.dtype)


def _merge_sliced(w_global, payloads, delta, fmt, w1, w2, denom, any_push,
                  n_pods):
    """Receiver-side plain merge: decode pod ``i``'s payload row and fold
    ``w2_i*(g + r_i)`` into the accumulator, so no pod-stacked fp32 tree is
    materialised.  A leaf blocked on the pod axis itself (a stacked scalar)
    has no per-pod rows and takes the stacked decode."""
    g_leaves, treedef = tree_flatten(w_global)
    out = []
    for g, p, dl in zip(g_leaves, flatten_up_to(treedef, payloads),
                        flatten_up_to(treedef, delta)):
        gf = g.to(torch.float32)
        acc = w1 * gf
        if all(a.ndim >= 1 and a.shape[0] == n_pods for a in p.values()):
            for i in range(n_pods):
                r = fmt.decode({k: a[i] for k, a in p.items()},
                               tuple(dl.shape[1:]), dl.dtype)
                acc = acc + w2[i] * (g + r).to(torch.float32)
        else:
            r = fmt.decode(p, dl.shape, dl.dtype)
            for i in range(n_pods):
                acc = acc + w2[i] * (g + r[i]).to(torch.float32)
        out.append(torch.where(any_push, acc / denom, gf).to(g.dtype))
    return tree_unflatten(treedef, out)


def _merge_recv(w_global, recv, w1, w2, denom, any_push, use_kernel):
    """The merge over reconstructed pod-stacked models (``none``/``fp16``,
    or the decode fallback)."""
    if use_kernel:
        return tree_map(lambda g, p: ops.loss_weighted_update(
            g, p, w1, w2, denom, any_push), w_global, recv)
    return tree_map(lambda g, p: _merge_leaf(g, p, w1, w2, denom, any_push),
                    w_global, recv)


def hermes_merge(pod_params: Tree, gates: torch.Tensor, losses: torch.Tensor,
                 w_global: Tree, L: torch.Tensor, *, compression: str = "none",
                 error: Optional[Tree] = None, use_kernel: bool = False,
                 round_step: int = 0, noise: Optional[NoiseFn] = None,
                 track_error: bool = True):
    """One gated loss-weighted merge.  Returns ``(new_pod_params,
    new_w_global, new_error, any_push)``; closed pods keep their params and
    pending error, and a fully closed merge returns ``w_global`` values
    unchanged.  ``round_step``/``noise`` drive stochastic formats."""
    gates = gates.to(torch.bool)
    n_pods = int(gates.shape[0])
    dev = gates.device
    any_push = gates.any()
    one = torch.ones((), dtype=torch.float32, device=dev)
    w1 = one / torch.clamp(L.to(device=dev, dtype=torch.float32), min=_EPS)
    w2 = torch.where(gates,
                     one / torch.clamp(losses.to(torch.float32), min=_EPS),
                     torch.zeros((), dtype=torch.float32, device=dev))
    denom = w1 + torch.sum(w2)

    # Closed pods transmit nothing: zero-masked out of every wire and merge
    # term, so a diverged (nonfinite) replica cannot poison the global model
    # through its 0-weight contribution (0 * nan = nan).
    def _gate_zero(leaf):
        return torch.where(_pod_mask(gates, leaf), leaf,
                           torch.zeros((), dtype=leaf.dtype, device=dev))

    if compression != "none":
        fmt = get_format(compression)
        delta = tree_map(lambda p, g: _gate_zero(p - g[None]), pod_params,
                         w_global)
        err_in = None if error is None else tree_map(_gate_zero, error)
        # the residual stays with the sender: it never crosses the pod axis
        payloads, _, residual = encode_tree(
            delta, compression, error=err_in, round_step=round_step,
            noise=noise, with_residual=track_error)
        if not track_error:
            new_error = None
        elif error is None:
            new_error = tree_map(_gate_zero, residual)
        else:
            new_error = tree_map(
                lambda r, e: torch.where(_pod_mask(gates, r), r, e),
                residual, error)
        payloads = gather_payloads(payloads)
        if use_kernel and fmt.fused_merge is not None:
            g_leaves, treedef = tree_flatten(w_global)
            merged = []
            for g, p, dl in zip(g_leaves, flatten_up_to(treedef, payloads),
                                flatten_up_to(treedef, delta)):
                if block_axis((n_pods,) + tuple(g.shape)) >= 1:
                    merged.append(fmt.fused_merge(g, p, w2, denom, any_push))
                else:  # blocked on the pod axis: no per-pod block layout
                    r = fmt.decode(p, dl.shape, dl.dtype)
                    merged.append(_merge_leaf(g, g[None] + r, w1, w2, denom,
                                              any_push))
            new_global = tree_unflatten(treedef, merged)
        elif use_kernel:
            rec = decode_tree(payloads, delta, compression)
            recv = tree_map(lambda g, d: g[None] + d, w_global, rec)
            new_global = _merge_recv(w_global, recv, w1, w2, denom, any_push,
                                     True)
        else:
            new_global = _merge_sliced(w_global, payloads, delta, fmt, w1, w2,
                                       denom, any_push, n_pods)
    else:
        recv = gather_payloads(tree_map(_gate_zero, pod_params))
        new_error = error if track_error else None
        new_global = _merge_recv(w_global, recv, w1, w2, denom, any_push,
                                 use_kernel)

    # refresh: pushing pods restart from the merged global model
    new_pods = tree_map(
        lambda p, g: torch.where(_pod_mask(gates, p), g[None], p),
        pod_params, new_global)
    return new_pods, new_global, new_error, any_push


def hermes_round(pod_params: Tree, gup_state: Dict[str, torch.Tensor],
                 pod_losses: torch.Tensor, w_global: Tree, L: torch.Tensor,
                 cfg: HermesConfig, *, error: Optional[Tree] = None,
                 use_kernel: Optional[bool] = None, round_step: int = 0,
                 noise: Optional[NoiseFn] = None) -> Dict[str, Any]:
    """One Level-B round: per-pod Algorithm-1 gates, admission, then the
    merge.  ``use_kernel=None`` resolves ``cfg.kernel_dispatch`` against
    the device of ``pod_losses``.  Returns a dict: pod_params, w_global,
    gup, error, gates, any_push."""
    if cfg.async_rounds:
        raise NotImplementedError("async rounds are not ported yet")
    if cfg.n_clusters > 1:
        raise NotImplementedError("two-tier clusters are not ported yet")
    if use_kernel is None:
        use_kernel = resolve_kernel_dispatch(cfg.kernel_dispatch,
                                             pod_losses.device)
    gates, new_gup = gup_gate(gup_state, pod_losses, cfg)
    gates = admit_gates(gates, pod_losses, cfg)
    any_push = gates.any()
    err_in = error if cfg.error_feedback else None
    # The reference skips the merge with lax.cond(any_push); here the flag
    # is read on the host, once per round boundary.
    if bool(any_push):
        new_pods, new_global, new_error, _ = hermes_merge(
            pod_params, gates, pod_losses, w_global, L,
            compression=cfg.compression, error=err_in, use_kernel=use_kernel,
            round_step=round_step, noise=noise,
            track_error=cfg.error_feedback)
    else:
        new_pods, new_global, new_error = pod_params, w_global, err_in
        # a compressed error-tracking round with no residual yet starts one
        # at zero, as the reference's closed branch does
        if (cfg.compression != "none" and cfg.error_feedback
                and new_error is None):
            new_error = tree_map(torch.zeros_like, pod_params)
    return {"pod_params": new_pods, "w_global": new_global, "gup": new_gup,
            "error": new_error, "gates": gates, "any_push": any_push}
