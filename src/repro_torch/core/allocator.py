"""Dynamic dataset & mini-batch sizing via dual binary search (paper §IV-A;
the reference's ``core/allocator.py``, numpy on the host, same arithmetic).

Model:  t_train = K * E * DSS / MBS            (Eq. 3)

1. Observe per-worker iteration times; flag outliers with the IQR rule
   ``t not in [Q1 - 1.5*IQR, Q3 + 1.5*IQR]`` (both stragglers and
   under-utilized fast nodes).
2. For each outlier, estimate its constant ``K = t * MBS / (E * DSS)`` from
   the latest observation.
3. Dual binary search: outer over the power-of-two MBS choices, inner over
   DSS in [dss_min, dss_max], to land the predicted time at the cluster
   median.  O(lg N * lg K) probes of the analytic model — no benchmarking
   runs (the EBSP weakness the paper calls out).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.config import HermesConfig


@dataclasses.dataclass(frozen=True)
class Allocation:
    dss: int
    mbs: int

    @property
    def steps_per_iteration(self) -> int:
        return max(1, self.dss // self.mbs)


def quartiles(times: Sequence[float]) -> Tuple[float, float, float]:
    q1, q2, q3 = np.percentile(np.asarray(times, np.float64), [25, 50, 75])
    return float(q1), float(q2), float(q3)


def detect_outliers_arr(vals: np.ndarray, k: float = 1.5) -> np.ndarray:
    """Array core of :func:`detect_outliers`: bool outlier mask over a
    (n,) vector of observed times.  One ``np.percentile`` + vectorized
    fence comparisons — no Python loop over workers, so the 10k-fleet
    sweep runs in microseconds."""
    vals = np.asarray(vals, np.float64)
    n = vals.shape[0]
    if n < 2:
        return np.zeros((n,), bool)
    r = 1.0 + k
    if n == 2:
        lo, hi = float(vals.min()), float(vals.max())
        flag = hi > r * max(lo, 1e-12)
        return np.full((2,), flag, bool)
    if n < 4:
        _, med, _ = quartiles(vals)
        lo, hi = med / r, med * r
    else:
        q1, _, q3 = quartiles(vals)
        iqr = q3 - q1
        lo, hi = q1 - k * iqr, q3 + k * iqr
    return (vals < lo) | (vals > hi)


def detect_outliers(times: Dict[str, float], k: float = 1.5) -> List[str]:
    """Workers whose time falls outside [Q1 - k*IQR, Q3 + k*IQR].

    Below 4 observations the IQR fences degenerate (with 3 samples Q3 is
    interpolated halfway toward the max, so no straggler is ever flagged),
    which used to switch dynamic allocation off exactly when deaths shrink
    the cluster into the straggler regime the paper targets.  3 members
    fall back to a median-ratio rule: an outlier is more than ``1 + k``
    times the median away from it (either direction).  2 members compare
    the pair directly — the median of two is their midpoint, so no ratio
    fence around it can ever catch the straggler — and when they diverge
    by more than ``1 + k`` *both* are flagged, resizing both toward the
    midpoint target (the slow one sheds work, the fast one absorbs it).

    Thin dict wrapper over :func:`detect_outliers_arr` (same fences, same
    float arithmetic — ``np.percentile`` is order-invariant)."""
    mask = detect_outliers_arr(np.asarray(list(times.values()), np.float64),
                               k)
    return [w for w, m in zip(times, mask) if m]


def estimate_k(t_train: float, epochs: int, dss: int, mbs: int) -> float:
    """Invert Eq. 3 for the per-worker constant K (time per mini-batch)."""
    steps = max(1, (dss // mbs)) * max(1, epochs)
    return t_train / steps


def predicted_time(k: float, epochs: int, dss: int, mbs: int) -> float:
    return k * max(1, epochs) * max(1, dss // mbs)


def _search_dss(k: float, epochs: int, mbs: int, t_target: float,
                dss_lo: int, dss_hi: int) -> int:
    """Inner binary search: largest DSS with predicted time <= t_target."""
    lo, hi = dss_lo, dss_hi
    best = dss_lo
    while lo <= hi:
        mid = (lo + hi) // 2
        if predicted_time(k, epochs, mid, mbs) <= t_target:
            best = mid
            lo = mid + 1
        else:
            hi = mid - 1
    return best


def dual_binary_search(k: float, t_target: float, *, epochs: int = 1,
                       dss_domain: Tuple[int, int] = (16, 60000),
                       mbs_choices: Sequence[int] = (2, 4, 8, 16, 32, 64, 128, 256),
                       mem_limit_dss: int = 10 ** 9) -> Allocation:
    """Outer binary search over MBS, inner over DSS (paper Fig. 7).

    Picks the (DSS, MBS) whose predicted time is closest to ``t_target``;
    among near-ties prefers more data (larger DSS) so fast nodes contribute
    more, matching the paper's observation in §V-C.
    """
    dss_lo, dss_hi = dss_domain
    dss_hi = min(dss_hi, mem_limit_dss)
    choices = sorted(mbs_choices)
    best: Tuple[float, int, Allocation] = (float("inf"), 0, Allocation(dss_lo, choices[0]))

    lo, hi = 0, len(choices) - 1
    probed = set()

    def probe(mi: int):
        nonlocal best
        if mi in probed:
            return
        probed.add(mi)
        mbs = choices[mi]
        dss = _search_dss(k, epochs, mbs, t_target, dss_lo, dss_hi)
        dss = max(dss, mbs)  # at least one mini-batch
        t = predicted_time(k, epochs, dss, mbs)
        err = abs(t - t_target)
        # prefer smaller error; tie-break on larger dss
        if err < best[0] - 1e-9 or (abs(err - best[0]) <= 1e-9 and dss > best[2].dss):
            best = (err, mi, Allocation(dss, mbs))

    # outer binary search: predicted_time at the DSS optimum is monotone-ish
    # in MBS (larger MBS -> fewer steps -> can afford more data); probe the
    # midpoint and walk toward lower error.
    while lo <= hi:
        mid = (lo + hi) // 2
        probe(mid)
        if mid + 1 <= len(choices) - 1:
            probe(mid + 1)
        t_mid = predicted_time(k, epochs, best[2].dss, choices[mid])
        if t_mid > t_target and mid - 1 >= 0:
            hi = mid - 1
        else:
            lo = mid + 1
    return best[2]


def rejoin_gain_rounds(n_live: int, remaining_rounds: float) -> float:
    """Rounds of wall-time saved by admitting one more member (Eq. 3).

    The allocator re-splits the data so every member's per-round time
    scales by ``n/(n+1)`` once the newcomer takes its share (t = K*E*DSS/
    MBS is linear in DSS), so ``remaining_rounds`` of work finish
    ``remaining_rounds/(n+1)`` rounds sooner."""
    return remaining_rounds / max(1, n_live + 1)


def should_readmit(remaining_rounds: float, n_live: int,
                   cfg: HermesConfig) -> bool:
    """The re-admission policy (DESIGN.md §7, the grow path).

    A rejoin pays a recompile + re-shard stall worth
    ``cfg.rejoin_cost_rounds`` rounds; admit the recovered member only
    when the cost-model speedup over the expected remaining rounds
    amortizes it.  Near the end of a run a rejoin is pure overhead — the
    paper's dynamic-membership premise cuts both ways."""
    return rejoin_gain_rounds(n_live, remaining_rounds) > cfg.rejoin_cost_rounds


def reallocate(times: Dict[str, float], allocs: Dict[str, Allocation],
               cfg: HermesConfig, *, epochs: int = 1,
               dss_domain: Tuple[int, int] = (16, 60000),
               mem_limit_dss: Dict[str, int] = None
               ) -> Dict[str, Allocation]:
    """One allocator round: IQR outliers get re-sized toward the median."""
    out: Dict[str, Allocation] = {}
    if not times:
        return out
    _, med, _ = quartiles(list(times.values()))
    target = med if cfg.target == "median" else float(np.mean(list(times.values())))
    for w in detect_outliers(times, cfg.iqr_k):
        a = allocs[w]
        k = estimate_k(times[w], epochs, a.dss, a.mbs)
        lim = (mem_limit_dss or {}).get(w, 10 ** 9)
        out[w] = dual_binary_search(
            k, target, epochs=epochs, dss_domain=dss_domain,
            mbs_choices=cfg.mbs_choices, mem_limit_dss=lim)
    return out


# ---------------------------------------------------------------------------
# Vectorized sweep + participation admission (DESIGN.md §11, the 10k engine)
# ---------------------------------------------------------------------------


def allocate_batch(k_arr: np.ndarray, t_target: float, *, epochs: int = 1,
                   dss_domain: Tuple[int, int] = (16, 60000),
                   mbs_choices: Sequence[int] = (2, 4, 8, 16, 32, 64, 128,
                                                 256),
                   mem_limit_arr: np.ndarray = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Dual binary search for a whole outlier *batch* at once.

    Vectorized form of :func:`dual_binary_search`: for each of the (m,)
    per-worker constants ``k_arr`` pick the (DSS, MBS) whose predicted
    time ``k * E * (DSS // MBS)`` lands closest to ``t_target``.  The
    inner DSS search runs as ~17 lockstep binary-search iterations over
    the whole batch; the outer loop covers every MBS choice (8 of them),
    so the sweep costs O(|choices| * lg(dss_hi)) vector ops for ANY fleet
    size — no Python loop over workers.  Probing all choices (instead of
    the scalar path's heuristic midpoint walk) finds the true optimum of
    the same objective with the same larger-DSS tie-break, so batch
    allocations are never worse fits than the scalar path's.

    Returns ``(dss, mbs)`` int64 arrays of shape (m,).
    """
    k_arr = np.asarray(k_arr, np.float64)
    m = k_arr.shape[0]
    dss_lo, dss_hi = int(dss_domain[0]), int(dss_domain[1])
    if mem_limit_arr is None:
        mem_limit_arr = np.full((m,), 10 ** 9, np.int64)
    hi_arr = np.minimum(dss_hi, np.asarray(mem_limit_arr, np.int64))
    E = max(1, int(epochs))
    best_err = np.full((m,), np.inf)
    best_dss = np.full((m,), dss_lo, np.int64)
    best_mbs = np.full((m,), int(sorted(mbs_choices)[0]), np.int64)
    for mbs in sorted(int(c) for c in mbs_choices):
        # largest DSS with predicted time <= t_target (per worker)
        lo = np.full((m,), dss_lo, np.int64)
        hi = hi_arr.copy()
        found = np.full((m,), dss_lo, np.int64)
        while True:
            open_ = lo <= hi
            if not open_.any():
                break
            mid = (lo + hi) // 2
            t_mid = k_arr * E * np.maximum(1, mid // mbs)
            ok = open_ & (t_mid <= t_target)
            found = np.where(ok, mid, found)
            lo = np.where(ok, mid + 1, lo)
            hi = np.where(open_ & ~ok, mid - 1, hi)
        dss = np.maximum(found, mbs)  # at least one mini-batch
        t = k_arr * E * np.maximum(1, dss // mbs)
        err = np.abs(t - t_target)
        # prefer smaller error; tie-break on larger dss (same rule as
        # dual_binary_search.probe)
        better = (err < best_err - 1e-9) | \
            ((np.abs(err - best_err) <= 1e-9) & (dss > best_dss))
        best_err = np.where(better, err, best_err)
        best_dss = np.where(better, dss, best_dss)
        best_mbs = np.where(better, mbs, best_mbs)
    return best_dss, best_mbs


def reallocate_arr(times: np.ndarray, dss: np.ndarray, mbs: np.ndarray,
                   cfg: HermesConfig, *, epochs: int = 1,
                   dss_domain: Tuple[int, int] = (16, 60000),
                   mem_limit_arr: np.ndarray = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Array-native :func:`reallocate`: one allocator round over (n,)
    observation/allocation vectors.  Returns ``(outlier_mask, new_dss,
    new_mbs)`` where the new allocations are only meaningful where the
    mask is set.  Used by the vectorized engine's sweep at fleet scale."""
    n = times.shape[0]
    mask = detect_outliers_arr(times, cfg.iqr_k)
    new_dss = np.asarray(dss, np.int64).copy()
    new_mbs = np.asarray(mbs, np.int64).copy()
    if not mask.any():
        return mask, new_dss, new_mbs
    _, med, _ = quartiles(times)
    target = med if cfg.target == "median" else float(np.mean(times))
    steps = np.maximum(1, dss[mask] // np.maximum(1, mbs[mask])) \
        * max(1, epochs)
    k_arr = times[mask] / steps
    lim = None if mem_limit_arr is None else mem_limit_arr[mask]
    d, m = allocate_batch(k_arr, target, epochs=epochs,
                          dss_domain=dss_domain,
                          mbs_choices=cfg.mbs_choices, mem_limit_arr=lim)
    new_dss[mask] = d
    new_mbs[mask] = m
    return mask, new_dss, new_mbs


def admission_mask(open_mask: np.ndarray, weights: np.ndarray,
                   prate: float, mode: str = "topk",
                   rng: np.random.Generator = None) -> np.ndarray:
    """Host-side participation admission over a push cohort (the numpy
    twin of ``dist.hermes_sync.admit_gates``; the vectorized engine uses
    it per macro-step).  Keeps at most ``max(1, floor(prate * n_open))``
    of the open entries: ``"topk"`` by descending ``weights`` (the
    Algorithm-2 merge weight 1/loss; stable index tie-break), ``"prob"``
    by Bernoulli(prate) thinning.  ``prate >= 1`` returns the mask
    unchanged."""
    open_mask = np.asarray(open_mask, bool)
    if prate >= 1.0:
        return open_mask
    n_open = int(open_mask.sum())
    if n_open == 0:
        return open_mask
    if mode == "prob":
        if rng is None:
            raise ValueError("admission 'prob' needs an rng")
        return open_mask & (rng.random(open_mask.shape) < prate)
    k = max(1, int(np.floor(prate * n_open)))
    w = np.where(open_mask, np.asarray(weights, np.float64), -np.inf)
    order = np.argsort(-w, kind="stable")
    out = np.zeros_like(open_mask)
    out[order[:k]] = True
    return out & open_mask


# ---------------------------------------------------------------------------
# Latency clustering (DESIGN.md §10, the hierarchical topology)
# ---------------------------------------------------------------------------

def kmeans_1d(times: Dict[str, float], n_clusters: int, *,
              iters: int = 32) -> Dict[str, int]:
    """Deterministic 1-D k-means over observed per-worker times.

    This is the cluster-assignment policy of the two-tier Hermes round:
    workers with similar observed iteration+transfer times (the
    allocator's ``latest_times`` signal) merge on fast intra-cluster
    links, and only one aggregated delta per cluster crosses the slow
    tier.  Everything here is deterministic so re-clustering at the
    allocator's sweep cadence is reproducible:

    * workers are sorted by ``(time, name)`` — the name tiebreak pins
      tied times to a stable order;
    * centroids initialize at evenly spaced quantiles of the sorted
      values (no RNG) and refine by Lloyd iterations;
    * a point equidistant to two centroids joins the lower-indexed one;
    * cluster ids are re-labeled by ascending centroid before returning,
      so cluster 0 is always the fastest tier;
    * with fewer workers than clusters, each worker gets a singleton
      cluster (rank order), and the surplus ids go unused.

    Returns ``{worker_name: cluster_id}`` with ids in
    ``[0, n_clusters)``.  Dropping one worker's entry and re-running
    moves no other worker across a boundary unless the centroids
    themselves move past it — the stability property the tests pin.
    """
    assert n_clusters >= 1, n_clusters
    if not times:
        return {}
    items = sorted(times.items(), key=lambda kv: (kv[1], kv[0]))
    names = [k for k, _ in items]
    vals = np.asarray([v for _, v in items], np.float64)
    labels = _kmeans_sorted_labels(vals, n_clusters, iters=iters)
    return {k: int(labels[i]) for i, k in enumerate(names)}


def _kmeans_sorted_labels(vals: np.ndarray, n_clusters: int, *,
                          iters: int = 32) -> np.ndarray:
    """Label core of :func:`kmeans_1d` over an already-sorted (n,) value
    vector.  Fully vectorized: quantile init, Lloyd refinement via
    ``np.bincount`` centroid means (no Python loop over workers or
    clusters), centroid-rank relabel — identical arithmetic to the dict
    path, which is a thin wrapper around this."""
    n = len(vals)
    if n_clusters == 1:
        return np.zeros((n,), np.int64)
    if n <= n_clusters:
        return np.arange(n, dtype=np.int64)
    # quantile-spread init over the sorted values (deterministic)
    q = (np.arange(n_clusters) + 0.5) / n_clusters
    cent = np.quantile(vals, q)
    assign = np.zeros((n,), np.int64)
    for it in range(max(1, iters)):
        # nearest centroid; exact ties -> lower cluster index (argmin)
        d = np.abs(vals[:, None] - cent[None, :])
        new_assign = np.argmin(d, axis=1)
        if it > 0 and np.array_equal(new_assign, assign):
            break
        assign = new_assign
        # per-cluster means in one bincount pass; an empty cluster keeps
        # its stale centroid (sum 0 / count 0 guarded), exactly like the
        # per-cluster loop this replaced
        cnt = np.bincount(assign, minlength=n_clusters)
        s = np.bincount(assign, weights=vals, minlength=n_clusters)
        nonempty = cnt > 0
        cent = np.where(nonempty, s / np.maximum(cnt, 1), cent)
    # re-label by ascending centroid; empty clusters sort last by their
    # (stale) centroid but receive no members, so ids stay in range
    order = np.argsort(cent, kind="stable")
    relabel = np.empty_like(order)
    relabel[order] = np.arange(n_clusters)
    return relabel[assign]


def kmeans_1d_arr(vals: np.ndarray, n_clusters: int, *,
                  iters: int = 32) -> np.ndarray:
    """Array-native :func:`kmeans_1d`: (n,) observed times in, (n,)
    cluster ids out (aligned to the input order).  The deterministic
    tie-break is by input *index* where the dict path breaks ties by
    name — same stability property, no dict or sort-by-name in the 10k
    sweep path."""
    assert n_clusters >= 1, n_clusters
    vals = np.asarray(vals, np.float64)
    n = vals.shape[0]
    if n == 0:
        return np.zeros((0,), np.int64)
    order = np.lexsort((np.arange(n), vals))
    labels_sorted = _kmeans_sorted_labels(vals[order], n_clusters,
                                          iters=iters)
    out = np.empty((n,), np.int64)
    out[order] = labels_sorted
    return out


def cluster_sizes(assignment: Dict[str, int], n_clusters: int) -> list:
    """Member count per cluster id, length ``n_clusters``."""
    out = [0] * n_clusters
    for c in assignment.values():
        out[c] += 1
    return out
