"""The Hermes round over pod-stacked trees (the reference's
``dist/hermes_sync.py``: ``hermes_pod_state``, ``hermes_grow_pod_state``,
``admit_gates``, ``hermes_merge``, ``hermes_round`` and its async halves
``hermes_dispatch`` / ``hermes_commit``, and the two-tier rounds
``hermes_cluster_merge`` / ``_round`` / ``_dispatch`` / ``_commit``).

Every round runs unplaced, all pods in one process (the reference's
``mesh=None``), or placed over the process groups of
``launch.mesh.PodGroups`` (``groups=``): each rank then holds its own pod
rows of every pod-stacked tree, gates its own pods, and the round's
collectives are the gate exchange and the payload gathers of
``dist.wire``.  A placed round is bitwise the unplaced one.  ``live``, an
``(n_pods,)`` membership mask, shuts dead pods out of a round.

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
  on the reconstructed pods in grouped calls (``none``: the whole tree in
  one; ``fp16``: a call a :func:`fallback_runs` run);
* plain: the receiver decodes pod ``i``'s payload row and accumulates
  ``w2_i*(g + r_i)`` on ``w1*g`` (the reference's ``_merge_sliced``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import HermesConfig
from repro_torch.core.gup import gup_gate
from repro_torch.dist.compression import encode_tree
from repro_torch.dist.wire import (
    GeneratorNoise, NoiseFn, RowNoise, all_gather_rows, block_axis,
    gather_payloads, gather_payloads_tiered, get_format,
    resolve_kernel_dispatch, row_local,
)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import PodGroups, placed
from repro_torch.utils.trees import (
    flatten_up_to, tree_flatten, tree_leaves, tree_map, tree_unflatten,
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


def hermes_grow_pod_state(gup_state: Dict[str, torch.Tensor],
                          cfg: HermesConfig,
                          n_new: int = 1) -> Dict[str, torch.Tensor]:
    """Append ``n_new`` fresh rows to a pod-stacked gate state (the grow
    path's mirror of :func:`hermes_pod_state`): an empty loss queue,
    zeroed count and n_iter, alpha back at ``cfg.alpha``.  A fresh row
    holds fewer than two losses for its first two rounds, so its gate
    cannot open while it warms up."""
    fresh = hermes_pod_state(cfg, n_new, gup_state["queue"].device)
    return {k: torch.cat([x, fresh[k].to(x.dtype)], dim=0)
            for k, x in gup_state.items()}


def _pod_mask(gates: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """(n,) gates shaped to broadcast against a (n, ...) stacked leaf."""
    return gates.reshape(gates.shape + (1,) * (leaf.ndim - 1))


#: the leaf index under which ``prob`` admission draws its uniforms from a
#: round's noise source (the reference folds its round key by 0xAD317)
ADMISSION_LEAF = 0xAD317


def admit_gates(gates: torch.Tensor, losses: torch.Tensor,
                cfg: HermesConfig, *, round_step: int = 0,
                noise: Optional[NoiseFn] = None) -> torch.Tensor:
    """Participation-rate admission on top of the z-score gate: keep at most
    ``max(1, floor(participation_rate * n_open))`` of the open gates.
    ``participation_rate >= 1`` returns ``gates``.

    ``admission="topk"`` keeps the ones with the largest merge weight
    ``1/loss`` (stable sort, ties to the lower pod index); ``"prob"`` thins
    the open gates i.i.d. Bernoulli(rate) with ``u = noise(round_step,
    ADMISSION_LEAF, (n_pods,))`` and needs ``noise``.  Both only clear gate
    bits: admitted is a subset of open."""
    prate = float(cfg.participation_rate)
    if prate >= 1.0:
        return gates
    gates = gates.to(torch.bool)
    if cfg.admission == "prob":
        if noise is None:
            raise ValueError("admission='prob' with participation_rate < 1 "
                             "needs a noise source")
        u = torch.as_tensor(noise(round_step, ADMISSION_LEAF,
                                  tuple(gates.shape)),
                            dtype=torch.float32, device=gates.device)
        return gates & (u < prate)
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
    """The merge over the pod-stacked models the ``none`` wire ships:
    every leaf in one grouped kernel call."""
    if use_kernel:
        g_leaves, treedef = tree_flatten(w_global)
        return tree_unflatten(treedef, ops.loss_weighted_update_group(
            list(zip(g_leaves, flatten_up_to(treedef, recv))), w1, w2,
            denom, any_push))
    return tree_map(lambda g, p: _merge_leaf(g, p, w1, w2, denom, any_push),
                    w_global, recv)


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """``x[0] + x[1] + ...`` left to right, a 0-d tensor.  A zero anywhere
    in ``x`` then adds nothing, so the sum with a masked pod's zero weight
    in it is bitwise the sum with the pod left out: the elastic invariant
    (masked == shrunk).  A device reduction regroups with the length: on
    the H100, ``torch.sum`` of ``(a, 0, b, c)`` and of ``(a, b, c)`` differ
    in the last bit for about one draw in four."""
    acc = x[0]
    for i in range(1, int(x.shape[0])):
        acc = acc + x[i]
    return acc


def _merge_weights(gates, losses, L):
    """Algorithm 2's weights: ``(w1, w2, denom, any_push)``, all on the
    device of ``gates``; a closed pod weighs 0, and ``denom`` sums the
    weights in pod order (:func:`_ordered_sum`)."""
    dev = gates.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    w1 = one / torch.clamp(L.to(device=dev, dtype=torch.float32), min=_EPS)
    w2 = torch.where(gates,
                     one / torch.clamp(losses.to(torch.float32), min=_EPS),
                     torch.zeros((), dtype=torch.float32, device=dev))
    return w1, w2, w1 + _ordered_sum(w2), gates.any()


def _gate_zero(gates, leaf):
    """Zero the rows of closed pods: they transmit nothing, so a diverged
    (nonfinite) replica cannot poison the global model through its
    0-weight contribution (0 * nan = nan)."""
    return torch.where(_pod_mask(gates, leaf), leaf,
                       torch.zeros((), dtype=leaf.dtype, device=leaf.device))


def _mine(x: torch.Tensor, groups) -> torch.Tensor:
    """This rank's rows of an ``(n_pods,)`` vector (all of it unplaced)."""
    return x[groups.rows] if placed(groups) else x


def _pushed_eff(pod_params, gates, w_global, compression, error, groups):
    """What the gate-open pods encode, this rank's rows: the gate-zeroed
    deltas with their gate-zeroed error-feedback residual folded in, as
    ``encode_tree`` would fold it (the lossless wire folds none)."""
    mine = _mine(gates, groups)
    eff = tree_map(lambda p, g: _gate_zero(mine, p - g[None]), pod_params,
                   w_global)
    if error is None or compression == "none":
        return eff
    return tree_map(lambda a, e: a + _gate_zero(mine, e), eff, error)


def _encode_rows(eff, compression, round_step, noise, with_residual,
                 rows: Optional[slice] = None, n_rows: int = 0,
                 whole=frozenset()):
    """Encode ``eff`` (``encode_tree``): with ``rows``, it holds this
    rank's ``rows`` of an ``(n_rows,)`` stacking (the leaves in ``whole``
    every row), and each leaf draws its noise as those rows of the whole
    draw.  Returns ``(payload per leaf, residual per leaf or None,
    treedef)``."""
    leaves, treedef = tree_flatten(eff)
    if rows is not None:
        base = noise if noise is not None else GeneratorNoise(
            0, leaves[0].device)
        noise = RowNoise(base, rows, n_rows, whole)
    payloads, _, residual = encode_tree(
        leaves, compression, round_step=round_step, noise=noise,
        with_residual=with_residual)
    return payloads, residual, treedef


def _pod_encode(eff, compression, round_step, noise, with_residual, groups,
                n_pods, whole):
    """The pod-tier encode of this rank's rows of ``eff``.  Placed, the
    leaves in ``whole`` (not row-local) gather their rows over the pod
    group first and encode whole on every rank, and keep this rank's rows
    of the residual."""
    if not placed(groups):
        return _encode_rows(eff, compression, round_step, noise,
                            with_residual)
    leaves, treedef = tree_flatten(eff)
    pod, size = groups.group("pod")
    leaves = [all_gather_rows(x, pod, size) if i in whole else x
              for i, x in enumerate(leaves)]
    payloads, residual, _ = _encode_rows(
        leaves, compression, round_step, noise, with_residual, groups.rows,
        n_pods, whole)
    if residual is not None:
        residual = [r[groups.rows] if i in whole else r
                    for i, r in enumerate(residual)]
    return payloads, residual, treedef


def _new_error(mine, residual, error, track_error, treedef):
    """The sender's error after an encode: the residual where the pod
    pushed, its pending error (or zeros) where it did not."""
    if not track_error:
        return None
    residual = tree_unflatten(treedef, residual)
    if error is None:
        return tree_map(lambda r: _gate_zero(mine, r), residual)
    return tree_map(lambda r, e: torch.where(_pod_mask(mine, r), r, e),
                    residual, error)


def _whole_leaves(compression, w_global, *row_counts) -> frozenset:
    """The leaves a placed round encodes whole on every rank (see
    ``wire.row_local``)."""
    return frozenset(i for i, g in enumerate(tree_flatten(w_global)[0])
                     if not row_local(compression, g.shape, *row_counts))


def _ship_rows(payloads, whole, gather):
    """Gather the payloads of every leaf not in ``whole`` (those already
    hold every row), leaf by leaf in leaf order."""
    idx = [i for i in range(len(payloads)) if i not in whole]
    shipped = gather([payloads[i] for i in idx])
    out = list(payloads)
    for i, p in zip(idx, shipped):
        out[i] = p
    return out


def _encode_push(pod_params, gates, w_global, compression, error,
                 round_step, noise, track_error, groups=None):
    """The sender half of a merge: the gate-zeroed deltas (or, uncompressed,
    replicas) encoded with error feedback and shipped.  Returns
    ``(payloads, new_error)``; closed pods keep their pending error.
    Placed, ``gates`` covers every pod and the rest this rank's rows;
    the payloads come back gathered, every pod's on every rank."""
    n_pods = int(gates.shape[0])
    mine = _mine(gates, groups)
    if compression == "none":
        return (gather_payloads(tree_map(lambda p: _gate_zero(mine, p),
                                         pod_params), groups, n_pods),
                error if track_error else None)
    eff = _pushed_eff(pod_params, gates, w_global, compression, error,
                      groups)
    whole = _whole_leaves(compression, w_global, n_pods) \
        if placed(groups) else frozenset()
    # the residual stays with the sender: it never crosses the pod axis
    payloads, residual, treedef = _pod_encode(
        eff, compression, round_step, noise, track_error, groups, n_pods,
        whole)
    payloads = _ship_rows(payloads, whole,
                          lambda ps: gather_payloads(ps, groups, n_pods))
    return (tree_unflatten(treedef, payloads),
            _new_error(mine, residual, error, track_error, treedef))


def _recv(g, p, fmt, n_pods):
    """The pods' reconstructed models ``g[None] + decode(p)``, summed into
    the decoded array when the decode made a new one (a whole pod-stacked
    temporary less at a vocabulary table; the same sum)."""
    d = fmt.decode(p, (n_pods,) + tuple(g.shape), g.dtype)
    if any(d.data_ptr() == a.data_ptr() for a in p.values()):
        return g[None] + d
    return d.add_(g[None])


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
    # the decode fallback: the leaves the fused merge left, reconstructed
    # and merged a run at a time, one grouped call a run
    rest = [i for i, m in enumerate(merged) if m is None]
    for run in fallback_runs([n_pods * g_leaves[i].numel()
                              * g_leaves[i].element_size() for i in rest]):
        idx = [rest[k] for k in run]
        for i, out in zip(idx, _merge_run(
                [g_leaves[i] for i in idx], [pays[i] for i in idx], fmt,
                w1, w2, denom, any_push, n_pods)):
            merged[i] = out
    return tree_unflatten(treedef, merged)


def fallback_runs(sizes: Sequence[int]):
    """The decode fallback's runs of leaves, in order, whose reconstructed
    pods (``sizes``, bytes) together take at most the largest one's: a run
    at a time, the merge holds no more reconstructions at once than a
    merge leaf by leaf.  At qwen3-8b (1 layer, bf16, 2 pods) the two
    vocabulary tables run alone and the other 12 leaves together."""
    budget, runs, held = max(sizes, default=0), [], 0
    for k, size in enumerate(sizes):
        if runs and held + size <= budget:
            runs[-1].append(k)
            held += size
        else:
            runs.append([k])
            held = size
    return runs


def _merge_run(gs, pays, fmt, w1, w2, denom, any_push, n_pods):
    """One fallback run: reconstruct its leaves, then merge them (one
    grouped kernel call; a leaf blocked on the pod axis merges plain).
    The reconstructions are freed when it returns."""
    recvs = [_recv(g, p, fmt, n_pods) for g, p in zip(gs, pays)]
    if fmt.fused_merge_group is not None:  # blocked on the pod axis
        return [_merge_leaf(g, r, w1, w2, denom, any_push)
                for g, r in zip(gs, recvs)]
    return ops.loss_weighted_update_group(list(zip(gs, recvs)), w1, w2,
                                          denom, any_push)


def _refresh(pod_params, gates, new_global, in_place: bool = False):
    """Pushing pods restart from the merged global model.  ``in_place``
    writes each refreshed leaf back into its own tensor, a leaf at a time
    (the donated commit), and returns ``pod_params`` itself."""
    if not in_place:
        return tree_map(lambda p, g: torch.where(_pod_mask(gates, p),
                                                 g[None], p),
                        pod_params, new_global)
    for p, g in zip(tree_leaves(pod_params), tree_leaves(new_global)):
        p.copy_(torch.where(_pod_mask(gates, p), g[None], p))
    return pod_params


def _live(gates: torch.Tensor, live: Optional[torch.Tensor]) -> torch.Tensor:
    """Gates with the membership mask applied: a dead pod never pushes."""
    gates = gates.to(torch.bool)
    return gates if live is None else gates & live.to(device=gates.device,
                                                      dtype=torch.bool)


def hermes_merge(pod_params: Tree, gates: torch.Tensor, losses: torch.Tensor,
                 w_global: Tree, L: torch.Tensor, *, compression: str = "none",
                 error: Optional[Tree] = None, use_kernel: bool = False,
                 round_step: int = 0, noise: Optional[NoiseFn] = None,
                 track_error: bool = True, live: Optional[torch.Tensor] = None,
                 groups: Optional[PodGroups] = None):
    """One gated loss-weighted merge.  Returns ``(new_pod_params,
    new_w_global, new_error, any_push)``; closed pods keep their params and
    pending error, and a fully closed merge returns ``w_global`` values
    unchanged.  ``round_step``/``noise`` drive stochastic formats.

    ``live``, an ``(n_pods,)`` membership mask, shuts a dead pod's gate
    (it then ships zeros and refreshes not).  With ``groups`` (placed),
    ``gates``, ``losses`` and ``live`` cover every pod while
    ``pod_params`` and ``error`` hold this rank's rows: each rank encodes
    its own pods, the payloads are all-gathered over the pod group, and
    every rank merges them into its copy of ``w_global``."""
    gates = _live(gates, live)
    w1, w2, denom, any_push = _merge_weights(gates, losses, L)
    payloads, new_error = _encode_push(pod_params, gates, w_global,
                                       compression, error, round_step, noise,
                                       track_error, groups)
    new_global = _merge_payloads(w_global, payloads, w1, w2, denom, any_push,
                                 compression, use_kernel, int(gates.shape[0]))
    return (_refresh(pod_params, _mine(gates, groups), new_global),
            new_global, new_error, any_push)


def _gate(gup_state, pod_losses, cfg, round_step, noise, live=None,
          groups=None):
    """Per-pod Algorithm-1 gates, the membership mask, then admission:
    ``(gates, losses, new_gup)`` with ``gates`` and ``losses`` (fp32)
    over every pod.  Placed, each rank gates its own pods and the round's
    one control collective gathers every pod's loss and gate bit, so the
    admission, the merge weights and ``any_push`` are computed from the
    same full vectors on every rank (and every rank then issues the same
    collectives)."""
    gates, new_gup = gup_gate(gup_state, pod_losses, cfg)
    losses = pod_losses.to(torch.float32)
    if placed(groups):
        ctl = torch.stack([losses, gates.to(torch.float32)], dim=1)
        ctl = all_gather_rows(ctl, *groups.group("pod"))
        losses, gates = ctl[:, 0], ctl[:, 1] > 0
    gates = _live(gates, live)
    return admit_gates(gates, losses, cfg, round_step=round_step,
                       noise=noise), losses, new_gup


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
                 noise: Optional[NoiseFn] = None,
                 live: Optional[torch.Tensor] = None,
                 groups: Optional[PodGroups] = None) -> Dict[str, Any]:
    """One Level-B round: per-pod Algorithm-1 gates, admission, then the
    merge.  ``use_kernel=None`` resolves ``cfg.kernel_dispatch`` against
    the device of ``pod_losses``; ``round_step``/``noise`` drive the int4
    rounding and ``prob`` admission; ``live`` and ``groups`` as in
    :func:`hermes_merge` (placed, ``gup_state`` and ``pod_losses`` hold
    this rank's rows too).  Returns a dict: pod_params, w_global, gup,
    error, gates and losses (every pod's), any_push, and ``merged``, the
    host's copy of ``any_push`` that the round read to skip a closed
    merge (a caller reads it without another sync; the same on every
    rank).  ``cfg.async_rounds`` and ``cfg.n_clusters`` are not read
    here, as in the reference: the pipelined loop calls
    :func:`hermes_dispatch` and :func:`hermes_commit`, the two-tier one
    :func:`hermes_cluster_round`."""
    if use_kernel is None:
        use_kernel = resolve_kernel_dispatch(cfg.kernel_dispatch,
                                             pod_losses.device)
    gates, losses, new_gup = _gate(gup_state, pod_losses, cfg, round_step,
                                   noise, live, groups)
    any_push = gates.any()
    err_in = error if cfg.error_feedback else None
    # The reference skips the merge with lax.cond(any_push); here the flag
    # is read on the host, once per round boundary.
    merged = bool(any_push)
    if merged:
        new_pods, new_global, new_error, _ = hermes_merge(
            pod_params, gates, losses, w_global, L,
            compression=cfg.compression, error=err_in, use_kernel=use_kernel,
            round_step=round_step, noise=noise,
            track_error=cfg.error_feedback, groups=groups)
    else:
        new_pods, new_global = pod_params, w_global
        new_error = _closed_error(cfg, err_in, pod_params)
    return {"pod_params": new_pods, "w_global": new_global, "gup": new_gup,
            "error": new_error, "gates": gates, "losses": losses,
            "any_push": any_push, "merged": merged}


# Async rounds (the reference's DESIGN.md section 8): ``hermes_round`` split
# in two.  ``hermes_dispatch`` gates, encodes and ships at round k and
# returns the gathered payload as ``pending``; ``hermes_commit`` merges it
# at round k+1, before that round's dispatch.  Between the two no other
# commit runs, so the commit sees ``w_global`` exactly as the dispatch
# encoded against, and the merge is the synchronous round-k merge landing
# one round of local steps late (staleness 1).  Placed, the gather runs in
# the dispatch and the commit issues no collective; eager PyTorch waits
# for a collective where it is issued, so the split changes when a merge
# lands, not what overlaps.


def hermes_dispatch(pod_params: Tree, gup_state: Dict[str, torch.Tensor],
                    pod_losses: torch.Tensor, w_global: Tree, L: torch.Tensor,
                    cfg: HermesConfig, *, error: Optional[Tree] = None,
                    round_step: int = 0, noise: Optional[NoiseFn] = None,
                    live: Optional[torch.Tensor] = None,
                    groups: Optional[PodGroups] = None) -> Dict[str, Any]:
    """The dispatch half of a pipelined round: gate, admit, encode, ship.

    The sender-side error residual updates here, at encode time.  Returns
    a dict: gup, error, gates, losses, any_push, and ``pending`` =
    ``{"payload", "gates", "losses", "L", "any_push"}`` for
    :func:`hermes_commit`.  As in :func:`hermes_round`, ``any_push`` is
    read on the host: a closed dispatch encodes and ships nothing and
    pends ``payload=None``, which its commit takes as the identity.
    ``live`` and ``groups`` as in :func:`hermes_merge`."""
    gates, losses, new_gup = _gate(gup_state, pod_losses, cfg, round_step,
                                   noise, live, groups)
    any_push = gates.any()
    err_in = error if cfg.error_feedback else None
    payload = None
    if bool(any_push):
        payload, new_error = _encode_push(
            pod_params, gates, w_global, cfg.compression, err_in, round_step,
            noise, cfg.error_feedback, groups)
    else:
        new_error = _closed_error(cfg, err_in, pod_params)
    pending = {"payload": payload, "gates": gates, "losses": losses,
               "L": L.to(device=gates.device, dtype=torch.float32),
               "any_push": any_push}
    return {"gup": new_gup, "error": new_error, "gates": gates,
            "losses": losses, "any_push": any_push, "pending": pending}


def pending_merges(pending: Dict[str, Any]) -> bool:
    """Does committing ``pending`` merge a payload?  Read on the host
    without a sync: a closed dispatch, flat or two-tier, pends none."""
    return pending.get("cluster_payload", pending.get("payload")) is not None


def hermes_commit(pod_params: Tree, pending: Dict[str, Any], w_global: Tree,
                  *, cfg: HermesConfig, live: Optional[torch.Tensor] = None,
                  groups: Optional[PodGroups] = None,
                  in_place: bool = False) -> Dict[str, Any]:
    """The commit half: merge a pending payload, one round late.

    Re-derives Algorithm 2's weights from the dispatch-time losses and
    ``L`` in ``pending``, merges with the same fused, kernel or sliced
    merge as :func:`hermes_merge` (``cfg.kernel_dispatch`` resolved
    against the device of the gates), and refreshes the pods whose gates were
    open at dispatch.  ``live`` re-masks those gates with the current
    membership: a pod that died after its dispatch weighs 0 and is not
    refreshed, so its push never merges posthumously.  The payload was
    gathered at dispatch, so a placed commit issues no collective.
    Returns ``{"pod_params", "w_global", "gates", "any_push"}``; a closed
    dispatch commits as the identity.  The caller drops ``pending``
    afterwards, which frees the payload.  ``in_place`` writes the
    refreshed rows into ``pod_params``' own leaves (the donating commit of
    ``launch.train.make_async_round_fns``); by default the commit is
    functional, as the reference's ``hermes_commit``."""
    gates = _live(pending["gates"], live)
    if pending["payload"] is None:
        return {"pod_params": pod_params, "w_global": w_global,
                "gates": gates, "any_push": gates.any()}
    use_kernel = resolve_kernel_dispatch(cfg.kernel_dispatch, gates.device)
    w1, w2, denom, any_push = _merge_weights(gates, pending["losses"],
                                             pending["L"])
    new_global = _merge_payloads(w_global, pending["payload"], w1, w2, denom,
                                 any_push, cfg.compression, use_kernel,
                                 int(gates.shape[0]))
    return {"pod_params": _refresh(pod_params, _mine(gates, groups),
                                   new_global, in_place),
            "w_global": new_global, "gates": gates, "any_push": any_push}


# Two-tier rounds (the reference's DESIGN.md section 10).  The merge splits
# along
#
#     merged = (w1*g + sum_i w2_i*(g + r_i)) / denom
#            =  g + (sum_c R_c) / denom,      R_c = sum_{i in c} w2_i * r_i
#
# (exact because denom = w1 + sum_i w2_i): each cluster reduces its
# members' weighted decoded deltas to one model-shaped partial R_c on the
# fast tier, re-encodes the stacked partials, and only that
# ``(n_clusters,)``-row payload crosses the slow tier.  At an effective
# cluster count of 1 every entry point calls its flat twin verbatim.  The
# slow-tier re-encode carries no error feedback; its int4 dither is the
# round's noise folded by 0x5C1.  The partials and the cluster merge are
# plain PyTorch ops accumulated in the reference's order (a member at a
# time, then a cluster at a time), as the reference keeps them out of its
# kernels; the wire's grouped pack and unpack still run on both tiers.
#
# Placed over ``PodGroups`` with a cluster tier, each rank all-gathers its
# cluster's member payloads over its intra-cluster group (the fast tier),
# computes its cluster's partial (so the partial is replicated within the
# cluster), encodes that one row with its rows of the whole dither, and
# all-gathers the ``(1,)``-row cluster payloads over its cross-cluster
# group (the slow tier), which gives every rank all ``n_clusters`` rows.

#: the fold of a round's noise for the slow-tier re-encode (the
#: reference's ``fold_in(rng, 0x5C1)``)
CLUSTER_FOLD = 0x5C1


def resolve_n_clusters(cfg: HermesConfig, n_clusters: Optional[int] = None,
                       cluster_sizes: Optional[Sequence[int]] = None) -> int:
    """Effective cluster count: explicit sizes > explicit count > config."""
    if cluster_sizes is not None:
        return len(cluster_sizes)
    if n_clusters is not None:
        return int(n_clusters)
    return int(cfg.n_clusters or 1)


def _cluster_index(n_pods: int, n_clusters: int,
                   cluster_sizes: Optional[Sequence[int]] = None
                   ) -> np.ndarray:
    """Static pod-row -> cluster-id map, cluster-major (the layout of
    ``launch.mesh.make_pod_groups``)."""
    if cluster_sizes is None:
        assert n_pods % n_clusters == 0, (n_pods, n_clusters)
        return np.repeat(np.arange(n_clusters), n_pods // n_clusters)
    sizes = [int(s) for s in cluster_sizes]
    assert sum(sizes) == n_pods, (sizes, n_pods)
    assert all(s >= 1 for s in sizes), sizes
    return np.repeat(np.arange(len(sizes)), sizes)


def _member_grid(w2: torch.Tensor, n_pods: int, C: int,
                 cluster_sizes: Optional[Sequence[int]]):
    """``(w2r (C, ppc), regroup)``: the per-member weights and the map of
    an ``(n_pods,) + rest`` array onto its ``(C, ppc) + rest`` member
    grid.  Uneven ``cluster_sizes`` pad each cluster to the largest with
    slots that replay row 0 at weight exactly 0."""
    w2 = w2.to(torch.float32)
    if cluster_sizes is None:
        ppc = n_pods // C
        return w2.reshape(C, ppc), \
            lambda a: a.reshape((C, ppc) + tuple(a.shape[1:]))
    sizes = [int(s) for s in cluster_sizes]
    ppc = max(sizes)
    idx = np.zeros((C, ppc), np.int64)
    wm = np.zeros((C, ppc), np.float32)
    s0 = 0
    for c, s in enumerate(sizes):
        idx[c, :s] = np.arange(s0, s0 + s)
        wm[c, :s] = 1.0
        s0 += s
    flat = torch.as_tensor(idx.reshape(-1), device=w2.device)
    w2r = w2.index_select(0, flat).reshape(C, ppc) \
        * torch.as_tensor(wm, device=w2.device)
    return w2r, lambda a: a.index_select(0, flat.to(a.device)).reshape(
        (C, ppc) + tuple(a.shape[1:]))


def _cluster_partials(w_global: Tree, payloads: Tree, fmt, w2: torch.Tensor,
                      n_pods: int, C: int,
                      cluster_sizes: Optional[Sequence[int]] = None,
                      own: Optional[int] = None, whole=frozenset()) -> Tree:
    """Per-cluster weighted partial sums ``R_c = sum_{i in c} w2_i * r_i``
    over the gathered payload rows, stacked on a leading ``(C,)``, fp32.

    Every leaf's rows decode in one grouped call (a row of the stacked
    decode is the decode of that row), then accumulate ``acc + w * r`` a
    member index at a time over the ``(C, ppc)`` grid.  Placed on a
    cluster tier (``own``: this rank's cluster), a leaf not in ``whole``
    holds only its own cluster's ``ppc`` rows and yields that cluster's
    partial alone, ``(1,) + leaf``."""
    g_leaves, treedef = tree_flatten(w_global)
    pays = flatten_up_to(treedef, payloads)
    w2r, regroup = _member_grid(w2, n_pods, C, cluster_sizes)
    ppc = w2r.shape[1]
    mine = [own is not None and i not in whole for i in range(len(g_leaves))]
    rows = [ppc if m else n_pods for m in mine]
    rs = fmt.decode_group(pays, [(n,) + tuple(g.shape)
                                 for n, g in zip(rows, g_leaves)],
                          [g.dtype for g in g_leaves])
    out = []
    for g, r, m in zip(g_leaves, rs, mine):
        rest = tuple(g.shape)
        if m:
            rr, wr = r.reshape((1, ppc) + rest), w2r[own:own + 1]
        else:
            rr, wr = regroup(r), w2r
        wshape = (wr.shape[0],) + (1,) * len(rest)
        acc = torch.zeros((wr.shape[0],) + rest, dtype=torch.float32,
                          device=g.device)
        for i in range(ppc):
            acc = acc + wr[:, i].reshape(wshape) * rr[:, i].to(torch.float32)
        out.append(acc)
    return tree_unflatten(treedef, out)


def _merge_cluster(w_global: Tree, cpayloads: Tree, fmt, denom, any_push,
                   C: int) -> Tree:
    """Fold the gathered per-cluster partials into the global model:
    ``merged = g + (sum_c decode(R'_c)) / denom``, summed a cluster at a
    time.  No per-cluster weight: a dropped cluster's payload rows are
    zeroed instead (:func:`_mask_cluster_rows`), so the sync round and the
    commit half run one graph."""
    g_leaves, treedef = tree_flatten(w_global)
    rs = fmt.decode_group(flatten_up_to(treedef, cpayloads),
                          [(C,) + tuple(g.shape) for g in g_leaves],
                          [g.dtype for g in g_leaves])
    out = []
    for g, r in zip(g_leaves, rs):
        gf = g.to(torch.float32)
        acc = torch.zeros(tuple(g.shape), dtype=torch.float32,
                          device=g.device)
        for c in range(C):
            acc = acc + r[c].to(torch.float32)
        out.append(torch.where(any_push, gf + acc / denom, gf).to(g.dtype))
    return tree_unflatten(treedef, out)


def _mask_cluster_rows(cpayloads: Tree, keep_c: torch.Tensor,
                       n_clusters: int) -> Tree:
    """Zero dropped clusters' rows of a gathered cluster payload.  Every
    wire array of it is ``(n_clusters,)``-leading, and every format
    decodes an all-zero row to exact zeros, so a masked row adds an exact
    ``+0.0`` to the merge."""
    C = int(n_clusters)

    def _mask(a):
        assert a.ndim >= 1 and int(a.shape[0]) == C, (
            "cluster payload arrays are (n_clusters,)-leading by "
            "construction", tuple(a.shape), C)
        m = keep_c.to(device=a.device).reshape((C,) + (1,) * (a.ndim - 1))
        return torch.where(m, a, torch.zeros((), dtype=a.dtype,
                                             device=a.device))

    return tree_map(_mask, cpayloads)


def _check_clusters(n_pods, C, cluster_sizes, groups):
    """The reference's refusals: uneven clusters run unplaced only, and a
    placed cluster tier must be the round's."""
    if cluster_sizes is not None and placed(groups):
        raise ValueError("uneven cluster_sizes run unplaced; a placed run "
                         "uses the flat round until the cluster grid "
                         "rebalances")
    if placed(groups) and groups.n_clusters not in (1, C):
        raise ValueError(f"groups hold {groups.n_clusters} clusters, the "
                         f"round {C}")
    _cluster_index(n_pods, C, cluster_sizes)  # validates the split


def _cluster_push(pod_params, gates, w2, w_global, compression, error,
                  round_step, noise, track_error, C, cluster_sizes, groups):
    """The two-tier sender side: the pod-tier encode with error feedback
    (the lossless wire ships the delta, not the replica), the fast-tier
    gather, the per-cluster partials cast to the leaf dtype, their
    re-encode without error feedback, and the slow-tier gather.  Returns
    ``(cluster payloads, (C,) rows on every rank; new_error)``."""
    n_pods = int(gates.shape[0])
    fmt = get_format(compression)
    mine = _mine(gates, groups)
    eff = _pushed_eff(pod_params, gates, w_global, compression, error,
                      groups)
    compressed = compression != "none"
    whole = _whole_leaves(compression, w_global, n_pods, C) \
        if placed(groups) else frozenset()
    payloads, residual, treedef = _pod_encode(
        eff, compression, round_step, noise, track_error and compressed,
        groups, n_pods, whole)
    if compressed:
        new_error = _new_error(mine, residual, error, track_error, treedef)
    else:  # a lossless wire drops nothing
        new_error = error if track_error else None
    # fast tier: every cluster gathers its own members' payload rows
    payloads = _ship_rows(payloads, whole, lambda ps: gather_payloads_tiered(
        ps, groups, n_pods))
    tiered = placed(groups) and groups.n_clusters > 1
    own = groups.cluster if tiered else None
    partials = _cluster_partials(w_global, tree_unflatten(treedef, payloads),
                                 fmt, w2, n_pods, C, cluster_sizes, own, whole)
    partials = tree_map(lambda a, g: a.to(g.dtype), partials, w_global)
    # slow tier: one row a cluster, with that row of the folded dither
    cnoise = None if noise is None else noise.fold(CLUSTER_FOLD)
    cpayloads, _, _ = _encode_rows(
        partials, compression, round_step, cnoise, False,
        slice(own, own + 1) if tiered else None, C, whole)
    cpayloads = _ship_rows(cpayloads, whole, lambda ps: gather_payloads(
        ps, groups if tiered else None, C, axis="cluster"))
    return tree_unflatten(treedef, cpayloads), new_error


def hermes_cluster_merge(pod_params: Tree, gates: torch.Tensor,
                         losses: torch.Tensor, w_global: Tree,
                         L: torch.Tensor, *, n_clusters: int,
                         cluster_sizes: Optional[Sequence[int]] = None,
                         live: Optional[torch.Tensor] = None,
                         compression: str = "none",
                         error: Optional[Tree] = None, round_step: int = 0,
                         noise: Optional[NoiseFn] = None,
                         track_error: bool = True,
                         groups: Optional[PodGroups] = None):
    """The two-tier gated loss-weighted merge (the section comment above).

    The sender side is :func:`hermes_merge`'s; the ship then runs twice,
    the member payloads over the fast tier and the re-encoded
    ``(n_clusters,)``-row partials over the slow one.  ``cluster_sizes``
    (uneven clusters) runs unplaced only.  ``live`` and ``groups`` as in
    :func:`hermes_merge`; ``noise`` needs a ``fold`` for the slow tier.
    Returns ``(new_pod_params, new_w_global, new_error, any_push)``."""
    gates = _live(gates, live)
    n_pods, C = int(gates.shape[0]), int(n_clusters)
    assert C >= 1, C
    _check_clusters(n_pods, C, cluster_sizes, groups)
    w1, w2, denom, any_push = _merge_weights(gates, losses, L)
    cpayloads, new_error = _cluster_push(
        pod_params, gates, w2, w_global, compression, error, round_step,
        noise, track_error, C, cluster_sizes, groups)
    new_global = _merge_cluster(w_global, cpayloads, get_format(compression),
                                denom, any_push, C)
    return (_refresh(pod_params, _mine(gates, groups), new_global),
            new_global, new_error, any_push)


def hermes_cluster_round(pod_params: Tree, gup_state: Dict[str, torch.Tensor],
                         pod_losses: torch.Tensor, w_global: Tree,
                         L: torch.Tensor, cfg: HermesConfig, *,
                         n_clusters: Optional[int] = None,
                         cluster_sizes: Optional[Sequence[int]] = None,
                         live: Optional[torch.Tensor] = None,
                         error: Optional[Tree] = None,
                         use_kernel: Optional[bool] = None,
                         round_step: int = 0, noise: Optional[NoiseFn] = None,
                         groups: Optional[PodGroups] = None
                         ) -> Dict[str, Any]:
    """One two-tier round: :func:`hermes_round` with the merge replaced by
    :func:`hermes_cluster_merge`.  The cluster count resolves
    ``cluster_sizes`` > ``n_clusters`` > ``cfg.n_clusters``; at 1 this
    calls :func:`hermes_round` verbatim.  ``use_kernel`` only reaches that
    flat path: the two-tier partials and merge are plain.  Returns
    :func:`hermes_round`'s dict."""
    C = resolve_n_clusters(cfg, n_clusters, cluster_sizes)
    if C <= 1:
        return hermes_round(pod_params, gup_state, pod_losses, w_global, L,
                            cfg, error=error, use_kernel=use_kernel,
                            round_step=round_step, noise=noise, live=live,
                            groups=groups)
    gates, losses, new_gup = _gate(gup_state, pod_losses, cfg, round_step,
                                   noise, live, groups)
    _check_clusters(int(gates.shape[0]), C, cluster_sizes, groups)
    any_push = gates.any()
    err_in = error if cfg.error_feedback else None
    merged = bool(any_push)  # the reference's lax.cond, on the host
    if merged:
        new_pods, new_global, new_error, _ = hermes_cluster_merge(
            pod_params, gates, losses, w_global, L, n_clusters=C,
            cluster_sizes=cluster_sizes, compression=cfg.compression,
            error=err_in, round_step=round_step, noise=noise,
            track_error=cfg.error_feedback, groups=groups)
    else:
        new_pods, new_global = pod_params, w_global
        new_error = _closed_error(cfg, err_in, pod_params)
    return {"pod_params": new_pods, "w_global": new_global, "gup": new_gup,
            "error": new_error, "gates": gates, "losses": losses,
            "any_push": any_push, "merged": merged}


def hermes_cluster_dispatch(pod_params: Tree,
                            gup_state: Dict[str, torch.Tensor],
                            pod_losses: torch.Tensor, w_global: Tree,
                            L: torch.Tensor, cfg: HermesConfig, *,
                            n_clusters: Optional[int] = None,
                            cluster_sizes: Optional[Sequence[int]] = None,
                            live: Optional[torch.Tensor] = None,
                            error: Optional[Tree] = None,
                            round_step: int = 0,
                            noise: Optional[NoiseFn] = None,
                            groups: Optional[PodGroups] = None
                            ) -> Dict[str, Any]:
    """The dispatch half of a pipelined two-tier round.  The fast-tier
    gather and the partials retire here; ``pending`` carries the gathered
    ``cluster_payload`` (``(n_clusters,)``-row wire arrays) in place of
    the flat half's ``payload``, so only the slow tier's result waits a
    round.  At one cluster this calls :func:`hermes_dispatch` verbatim.
    A closed dispatch pends ``cluster_payload=None``, committed as the
    identity.  Returns :func:`hermes_dispatch`'s dict."""
    C = resolve_n_clusters(cfg, n_clusters, cluster_sizes)
    if C <= 1:
        return hermes_dispatch(pod_params, gup_state, pod_losses, w_global,
                               L, cfg, error=error, round_step=round_step,
                               noise=noise, live=live, groups=groups)
    gates, losses, new_gup = _gate(gup_state, pod_losses, cfg, round_step,
                                   noise, live, groups)
    _check_clusters(int(gates.shape[0]), C, cluster_sizes, groups)
    any_push = gates.any()
    err_in = error if cfg.error_feedback else None
    cpayload = None
    if bool(any_push):
        w2 = _merge_weights(gates, losses, L)[1]
        cpayload, new_error = _cluster_push(
            pod_params, gates, w2, w_global, cfg.compression, err_in,
            round_step, noise, cfg.error_feedback, C, cluster_sizes, groups)
    else:
        new_error = _closed_error(cfg, err_in, pod_params)
    pending = {"cluster_payload": cpayload, "gates": gates, "losses": losses,
               "L": L.to(device=gates.device, dtype=torch.float32),
               "any_push": any_push}
    return {"gup": new_gup, "error": new_error, "gates": gates,
            "losses": losses, "any_push": any_push, "pending": pending}


def hermes_cluster_commit(pod_params: Tree, pending: Dict[str, Any],
                          w_global: Tree, *, cfg: HermesConfig,
                          n_clusters: Optional[int] = None,
                          cluster_sizes: Optional[Sequence[int]] = None,
                          live: Optional[torch.Tensor] = None,
                          groups: Optional[PodGroups] = None,
                          in_place: bool = False) -> Dict[str, Any]:
    """The commit half of a pipelined two-tier round: fold a pending
    ``cluster_payload`` into the global model, one round late, with no
    collective.  A flat ``pending`` commits through :func:`hermes_commit`
    verbatim.

    ``live`` re-masks at cluster granularity: a cluster's partial is one
    weighted sum of its members' pushes, so if any pod gated at dispatch
    has died since, its whole cluster's rows are zeroed and every weight
    the partial carried leaves the denominator.  The cluster's survivors
    do not refresh (their push never merged); a pod that died ungated
    costs its cluster nothing.  Returns ``{"pod_params", "w_global",
    "gates", "any_push"}``; ``in_place`` as in :func:`hermes_commit`."""
    if "cluster_payload" not in pending:
        return hermes_commit(pod_params, pending, w_global, cfg=cfg,
                             live=live, groups=groups, in_place=in_place)
    gates_d = pending["gates"].to(torch.bool)
    dev, n_pods = gates_d.device, int(gates_d.shape[0])
    C = resolve_n_clusters(cfg, n_clusters, cluster_sizes)
    cidx = torch.as_tensor(_cluster_index(n_pods, C, cluster_sizes),
                           device=dev)
    lv = _live(torch.ones_like(gates_d), live)
    dropped = torch.zeros(C, dtype=torch.int32, device=dev).scatter_reduce(
        0, cidx, (gates_d & ~lv).to(torch.int32), "amax")
    keep_c = dropped == 0
    keep_pod = keep_c[cidx]
    gates = gates_d & lv & keep_pod
    any_push = gates.any()
    if pending["cluster_payload"] is None:
        return {"pod_params": pod_params, "w_global": w_global,
                "gates": gates, "any_push": any_push}
    _, _, denom, _ = _merge_weights(gates_d & keep_pod, pending["losses"],
                                    pending["L"])
    payload = _mask_cluster_rows(pending["cluster_payload"], keep_c, C)
    new_global = _merge_cluster(w_global, payload,
                                get_format(cfg.compression), denom, any_push,
                                C)
    return {"pod_params": _refresh(pod_params, _mine(gates, groups),
                                   new_global, in_place),
            "w_global": new_global, "gates": gates, "any_push": any_push}
