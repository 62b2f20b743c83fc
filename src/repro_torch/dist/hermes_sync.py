"""The Hermes round over pod-stacked trees (the reference's
``dist/hermes_sync.py``: ``hermes_pod_state``, ``admit_gates``,
``hermes_merge``, ``hermes_round`` and its async halves
``hermes_dispatch`` / ``hermes_commit``; unplaced, one cluster).

Trees are nested dicts of tensors; a pod-stacked tree carries a leading
``(n_pods,)`` axis on every leaf.  The merge is the paper's Algorithm 2 in
model space,

    w_global' = (W1 * w_global + sum_i W2_i * w_i) / (W1 + sum_i W2_i)

with ``W1 = 1/L(global)``, ``W2_i = 1/loss_i`` over the gate-open pods.
Gate-open pods push ``w_i - w_global`` through the wire format (with their
error-feedback residual folded in) and restart from the merged model.

Two merge associations, each pinned to its own reference path:

* kernels (``use_kernel``): int8 and int4 merge the wire payload into the
  global leaf with ``dequant_merge`` / ``dequant_merge_packed`` (``denom*g
  + sum w2_i*(q_i*s_i)``), ``none``/``fp16`` use ``loss_weighted_update``
  on the reconstructed pods;
* plain: the receiver decodes pod ``i``'s payload row and accumulates
  ``w2_i*(g + r_i)`` on ``w1*g`` (the reference's ``_merge_sliced``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.config import HermesConfig
from repro_torch.core.gup import gup_gate
from repro_torch.dist.compression import encode_tree
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


def _merge_sliced(w_global, payloads, fmt, w1, w2, denom, any_push, n_pods):
    """Receiver-side plain merge: decode pod ``i``'s payload row and fold
    ``w2_i*(g + r_i)`` into the accumulator, so no pod-stacked fp32 tree is
    materialised.  A leaf blocked on the pod axis itself (a stacked scalar)
    has no per-pod rows and takes the stacked decode."""
    g_leaves, treedef = tree_flatten(w_global)
    out = []
    for g, p in zip(g_leaves, flatten_up_to(treedef, payloads)):
        gf = g.to(torch.float32)
        acc = w1 * gf
        if all(a.ndim >= 1 and a.shape[0] == n_pods for a in p.values()):
            for i in range(n_pods):
                r = fmt.decode({k: a[i] for k, a in p.items()},
                               tuple(g.shape), g.dtype)
                acc = acc + w2[i] * (g + r).to(torch.float32)
        else:
            r = fmt.decode(p, (n_pods,) + tuple(g.shape), g.dtype)
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


def _merge_weights(gates, losses, L):
    """Algorithm 2's weights: ``(w1, w2, denom, any_push)``, all on the
    device of ``gates``; a closed pod weighs 0."""
    dev = gates.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    w1 = one / torch.clamp(L.to(device=dev, dtype=torch.float32), min=_EPS)
    w2 = torch.where(gates,
                     one / torch.clamp(losses.to(torch.float32), min=_EPS),
                     torch.zeros((), dtype=torch.float32, device=dev))
    return w1, w2, w1 + torch.sum(w2), gates.any()


def _gate_zero(gates, leaf):
    """Zero the rows of closed pods: they transmit nothing, so a diverged
    (nonfinite) replica cannot poison the global model through its
    0-weight contribution (0 * nan = nan)."""
    return torch.where(_pod_mask(gates, leaf), leaf,
                       torch.zeros((), dtype=leaf.dtype, device=leaf.device))


def _encode_push(pod_params, gates, w_global, compression, error,
                 round_step, noise, track_error):
    """The sender half of a merge: the gate-zeroed deltas (or, uncompressed,
    replicas) encoded with error feedback and shipped.  Returns
    ``(payloads, new_error)``; closed pods keep their pending error."""
    if compression == "none":
        return (gather_payloads(tree_map(lambda p: _gate_zero(gates, p),
                                         pod_params)),
                error if track_error else None)
    delta = tree_map(lambda p, g: _gate_zero(gates, p - g[None]), pod_params,
                     w_global)
    err_in = None if error is None else tree_map(
        lambda e: _gate_zero(gates, e), error)
    # the residual stays with the sender: it never crosses the pod axis
    payloads, _, residual = encode_tree(
        delta, compression, error=err_in, round_step=round_step,
        noise=noise, with_residual=track_error)
    if not track_error:
        new_error = None
    elif error is None:
        new_error = tree_map(lambda r: _gate_zero(gates, r), residual)
    else:
        new_error = tree_map(
            lambda r, e: torch.where(_pod_mask(gates, r), r, e),
            residual, error)
    return gather_payloads(payloads), new_error


def _merge_payloads(w_global, payloads, w1, w2, denom, any_push, compression,
                    use_kernel, n_pods):
    """The receiver half: merge the shipped payloads into ``w_global``
    (fused kernel, fp32 kernel, or the plain sliced association)."""
    if compression == "none":
        return _merge_recv(w_global, payloads, w1, w2, denom, any_push,
                           use_kernel)
    fmt = get_format(compression)
    if not use_kernel:
        return _merge_sliced(w_global, payloads, fmt, w1, w2, denom,
                             any_push, n_pods)
    g_leaves, treedef = tree_flatten(w_global)
    pays = flatten_up_to(treedef, payloads)
    merged = [None] * len(g_leaves)
    if fmt.fused_merge_group is not None:
        # every leaf blocked off the pod axis, in one grouped merge
        fused = [i for i, g in enumerate(g_leaves)
                 if block_axis((n_pods,) + tuple(g.shape)) >= 1]
        outs = fmt.fused_merge_group([g_leaves[i] for i in fused],
                                     [pays[i] for i in fused], w2, denom,
                                     any_push)
        for i, out in zip(fused, outs):
            merged[i] = out
    for i, (g, p) in enumerate(zip(g_leaves, pays)):
        if merged[i] is not None:
            continue
        recv = g[None] + fmt.decode(p, (n_pods,) + tuple(g.shape), g.dtype)
        if fmt.fused_merge_group is not None:  # blocked on the pod axis
            merged[i] = _merge_leaf(g, recv, w1, w2, denom, any_push)
        else:
            merged[i] = ops.loss_weighted_update(g, recv, w1, w2, denom,
                                                 any_push)
    return tree_unflatten(treedef, merged)


def _refresh(pod_params, gates, new_global):
    """Pushing pods restart from the merged global model."""
    return tree_map(lambda p, g: torch.where(_pod_mask(gates, p), g[None], p),
                    pod_params, new_global)


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
    w1, w2, denom, any_push = _merge_weights(gates, losses, L)
    payloads, new_error = _encode_push(pod_params, gates, w_global,
                                       compression, error, round_step, noise,
                                       track_error)
    new_global = _merge_payloads(w_global, payloads, w1, w2, denom, any_push,
                                 compression, use_kernel, int(gates.shape[0]))
    return (_refresh(pod_params, gates, new_global), new_global, new_error,
            any_push)


def _gate(gup_state, pod_losses, cfg):
    """Per-pod Algorithm-1 gates, then admission: ``(gates, new_gup)``."""
    if cfg.n_clusters > 1:
        raise NotImplementedError("two-tier clusters are not ported yet")
    gates, new_gup = gup_gate(gup_state, pod_losses, cfg)
    return admit_gates(gates, pod_losses, cfg), new_gup


def _closed_error(cfg, err_in, pod_params):
    """The error state after a closed round: a compressed error-tracking
    round with no residual yet starts one at zero, as the reference's
    closed branch does."""
    if cfg.compression != "none" and cfg.error_feedback and err_in is None:
        return tree_map(torch.zeros_like, pod_params)
    return err_in


def hermes_round(pod_params: Tree, gup_state: Dict[str, torch.Tensor],
                 pod_losses: torch.Tensor, w_global: Tree, L: torch.Tensor,
                 cfg: HermesConfig, *, error: Optional[Tree] = None,
                 use_kernel: Optional[bool] = None, round_step: int = 0,
                 noise: Optional[NoiseFn] = None) -> Dict[str, Any]:
    """One Level-B round: per-pod Algorithm-1 gates, admission, then the
    merge.  ``use_kernel=None`` resolves ``cfg.kernel_dispatch`` against
    the device of ``pod_losses``.  Returns a dict: pod_params, w_global,
    gup, error, gates, any_push, and ``merged``, the host's copy of
    ``any_push`` that the round read to skip a closed merge (a caller
    reads it without another sync).  ``cfg.async_rounds`` is not read
    here, as in the reference: the pipelined loop calls
    :func:`hermes_dispatch` and :func:`hermes_commit` instead."""
    if use_kernel is None:
        use_kernel = resolve_kernel_dispatch(cfg.kernel_dispatch,
                                             pod_losses.device)
    gates, new_gup = _gate(gup_state, pod_losses, cfg)
    any_push = gates.any()
    err_in = error if cfg.error_feedback else None
    # The reference skips the merge with lax.cond(any_push); here the flag
    # is read on the host, once per round boundary.
    merged = bool(any_push)
    if merged:
        new_pods, new_global, new_error, _ = hermes_merge(
            pod_params, gates, pod_losses, w_global, L,
            compression=cfg.compression, error=err_in, use_kernel=use_kernel,
            round_step=round_step, noise=noise,
            track_error=cfg.error_feedback)
    else:
        new_pods, new_global = pod_params, w_global
        new_error = _closed_error(cfg, err_in, pod_params)
    return {"pod_params": new_pods, "w_global": new_global, "gup": new_gup,
            "error": new_error, "gates": gates, "any_push": any_push,
            "merged": merged}


# Async rounds (the reference's DESIGN.md section 8): ``hermes_round`` split
# in two.  ``hermes_dispatch`` gates and encodes at round k and returns the
# payload as ``pending``; ``hermes_commit`` merges it at round k+1, before
# that round's dispatch.  Between the two no other commit runs, so the
# commit sees ``w_global`` exactly as the dispatch encoded against, and the
# merge is the synchronous round-k merge landing one round of local steps
# late (staleness 1).  With every pod on one card the payload gather is the
# identity, so the split changes when a merge lands, not what overlaps.


def hermes_dispatch(pod_params: Tree, gup_state: Dict[str, torch.Tensor],
                    pod_losses: torch.Tensor, w_global: Tree, L: torch.Tensor,
                    cfg: HermesConfig, *, error: Optional[Tree] = None,
                    round_step: int = 0, noise: Optional[NoiseFn] = None
                    ) -> Dict[str, Any]:
    """The dispatch half of a pipelined round: gate, admit, encode, ship.

    The sender-side error residual updates here, at encode time.  Returns
    a dict: gup, error, gates, any_push, and ``pending`` = ``{"payload",
    "gates", "losses", "L", "any_push"}`` for :func:`hermes_commit`.  As in
    :func:`hermes_round`, ``any_push`` is read on the host: a closed
    dispatch encodes nothing and pends ``payload=None``, which its commit
    takes as the identity."""
    gates, new_gup = _gate(gup_state, pod_losses, cfg)
    gates = gates.to(torch.bool)
    any_push = gates.any()
    err_in = error if cfg.error_feedback else None
    payload = None
    if bool(any_push):
        payload, new_error = _encode_push(
            pod_params, gates, w_global, cfg.compression, err_in, round_step,
            noise, cfg.error_feedback)
    else:
        new_error = _closed_error(cfg, err_in, pod_params)
    pending = {"payload": payload, "gates": gates,
               "losses": pod_losses.to(torch.float32),
               "L": L.to(device=gates.device, dtype=torch.float32),
               "any_push": any_push}
    return {"gup": new_gup, "error": new_error, "gates": gates,
            "any_push": any_push, "pending": pending}


def hermes_commit(pod_params: Tree, pending: Dict[str, Any], w_global: Tree,
                  *, cfg: HermesConfig) -> Dict[str, Any]:
    """The commit half: merge a pending payload, one round late.

    Re-derives Algorithm 2's weights from the dispatch-time losses and
    ``L`` in ``pending``, merges with the same fused, kernel or sliced
    merge as :func:`hermes_merge` (``cfg.kernel_dispatch`` resolved
    against the device of the gates), and refreshes the pods whose gates were
    open at dispatch.  Returns ``{"pod_params", "w_global", "gates",
    "any_push"}``; a closed dispatch commits as the identity.  The caller
    drops ``pending`` afterwards, which frees the payload."""
    gates = pending["gates"]
    if pending["payload"] is None:
        return {"pod_params": pod_params, "w_global": w_global,
                "gates": gates, "any_push": pending["any_push"]}
    use_kernel = resolve_kernel_dispatch(cfg.kernel_dispatch, gates.device)
    w1, w2, denom, any_push = _merge_weights(gates, pending["losses"],
                                             pending["L"])
    new_global = _merge_payloads(w_global, pending["payload"], w1, w2, denom,
                                 any_push, cfg.compression, use_kernel,
                                 int(gates.shape[0]))
    return {"pod_params": _refresh(pod_params, gates, new_global),
            "w_global": new_global, "gates": gates, "any_push": any_push}
