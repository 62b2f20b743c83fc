"""The fleet engine of the Level-A simulator (the reference's
``core/engine.py``): its batch / surrogate mode.

``run_framework`` selects it for a :class:`SurrogateBundle` or a
``churn`` trace.  No tensors: the bundle supplies an analytic loss curve,
and every round is one wavefront over flat ``(n,)`` numpy columns
(iteration times, data shares, GUP ring buffers, error-feedback mass,
byte meters) on the host.  Churn (:class:`ChurnTrace`: diurnal
availability, battery dropout, failure and recovery cycles) and
participation admission (``HermesConfig.participation_rate`` through
:func:`repro_torch.core.allocator.admission_mask`) are vectorized, so 10k
workers x 200 rounds take seconds.  ``RunResult.device`` is ``"host"``.

The reference's exact mode (``engine="vector"``), a slot scheduler whose
runs equal the legacy loops', is those loops here:
``simulator._run_hermes`` adds its one difference, Level-A ``prob``
admission.

Admission: the GUP gate advances on the raw z-score decision; admission
only thins which open gates ship.  A deferred push is safe because
pushes are w0-anchored (the next admitted push carries what the deferred
one would have), and the error-feedback residual carries any compressed
remainder.  ``participation_rate >= 1`` draws nothing, so it is bitwise
the ungated run.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.config import HermesConfig
from repro_torch.core.allocator import (Allocation, admission_mask,
                                        kmeans_1d_arr, reallocate_arr)
from repro_torch.core.cluster import TABLE_II_FAMILIES, CommModel, Meter
from repro_torch.core.simulator import RunResult, _check_stop, _StopCfg

#: measured payload_bytes / params_bytes of each wire format: the
#: surrogate engine bills wire bytes from these, as the physical push of a
#: model of the same size would ship
_WIRE_RATIO = {"none": 1.0, "fp16": 0.5, "int8": 0.2578, "int4": 0.1294}


# ---------------------------------------------------------------------------
# Surrogate inputs (batch mode only)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SurrogateBundle:
    """Analytic stand-in for :class:`ModelBundle` at 10k-worker scale.

    The global loss follows ``floor + (loss0 - floor) * exp(-rate * P)``
    where ``P`` is the accumulated push mass (each admitted push counts
    one, plus the mass deferred admission left behind); each worker's
    observed loss adds relative noise so the GUP z-gate sees variance.
    Accuracy is ``1 - loss/loss0``.
    """
    params_bytes: float = 4.0e6
    sample_bytes: float = 3140.0
    n_train: int = 1_000_000
    loss0: float = 2.3
    loss_floor: float = 0.12
    rate: float = 2.0e-3
    noise: float = 0.02
    eval_n: int = 64

    def global_loss(self, progress: float) -> float:
        return self.loss_floor + (self.loss0 - self.loss_floor) * float(
            np.exp(-self.rate * progress))

    def accuracy(self, progress: float) -> float:
        return float(np.clip(1.0 - self.global_loss(progress) / self.loss0,
                             0.0, 1.0))


@dataclasses.dataclass
class ChurnTrace:
    """Worker availability for the batch engine: three independent
    mechanisms, all vectorized.

    - **diurnal**: worker ``i`` is awake iff ``(t + phase_i) mod period``
      falls in the first ``duty`` share of the period (phases are drawn
      uniform from the seed, so availability rolls around the clock);
    - **battery**: computing drains ``battery`` by the iteration's
      duration; an empty battery parks the worker for ``recharge_s`` and
      then refills it;
    - **failures**: each live worker crashes with hazard ``failure_rate``
      a second and stays down for an exponential downtime of mean
      ``mean_downtime_s``; re-admission is billed like Level A's rejoin
      (pull + dataset transfer, fresh gate state).
    """
    diurnal_period_s: float = 0.0      # 0 disables the diurnal schedule
    diurnal_duty: float = 0.75
    battery_s: float = 0.0             # 0 disables battery dropout
    recharge_s: float = 120.0
    failure_rate: float = 0.0          # crash hazard a second, 0 disables
    mean_downtime_s: float = 60.0

    def validate(self) -> "ChurnTrace":
        assert self.diurnal_period_s >= 0.0, self.diurnal_period_s
        assert 0.0 < self.diurnal_duty <= 1.0, self.diurnal_duty
        assert self.battery_s >= 0.0, self.battery_s
        assert self.recharge_s > 0.0, self.recharge_s
        assert self.failure_rate >= 0.0, self.failure_rate
        assert self.mean_downtime_s > 0.0, self.mean_downtime_s
        return self


# ---------------------------------------------------------------------------
# Batch / surrogate mode: the 10k-worker engine
# ---------------------------------------------------------------------------

class _VecGup:
    """The GUP gate on flat arrays: one ring buffer of recent losses a
    worker, z-scored against its own history as
    :func:`repro_torch.core.gup.gup_update` does (z before the append,
    alpha decays after ``lam`` pushless iterations, alpha clamped to
    ``[alpha_min, alpha_max]``)."""

    def __init__(self, n: int, cfg: HermesConfig):
        self.w = int(cfg.window)
        self.cfg = cfg
        self.q = np.zeros((n, self.w))
        self.cnt = np.zeros((n,), np.int64)
        self.alpha = np.full((n,), float(cfg.alpha))
        self.n_iter = np.zeros((n,), np.int64)
        self.pushes = np.zeros((n,), np.int64)

    def reset(self, mask: np.ndarray):
        """Fresh gate state for re-admitted workers (the rejoin rule)."""
        self.cnt[mask] = 0
        self.alpha[mask] = float(self.cfg.alpha)
        self.n_iter[mask] = 0

    def update(self, loss: np.ndarray, active: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        k = np.minimum(self.cnt, self.w)
        valid = np.arange(self.w)[None, :] < k[:, None]
        cnt_f = np.maximum(k, 1).astype(float)
        mu = np.where(valid, self.q, 0.0).sum(axis=1) / cnt_f
        var = (np.where(valid, (self.q - mu[:, None]) ** 2, 0.0).sum(axis=1)
               / cnt_f)
        sigma = np.sqrt(var)
        ok = (k >= 2) & (sigma > 1e-12)
        z = np.where(ok, (loss - mu) / np.where(ok, sigma, 1.0), np.inf)
        push = active & (z <= self.alpha)
        # append after the decision, in ring order (the statistics do not
        # depend on the order)
        slot = (self.cnt % self.w).astype(np.intp)
        rows = np.flatnonzero(active)
        self.q[rows, slot[rows]] = loss[rows]
        self.cnt[rows] += 1
        self.pushes[push] += 1
        self.n_iter = np.where(push, 0, self.n_iter + active.astype(np.int64))
        decay = active & ~push & (self.n_iter >= cfg.lam)
        self.alpha = np.where(decay, np.minimum(self.alpha + cfg.beta,
                                                cfg.alpha_max), self.alpha)
        self.n_iter = np.where(decay, 0, self.n_iter)
        self.alpha = np.maximum(self.alpha, cfg.alpha_min)
        return push


def _serialized_ps(arrivals: np.ndarray, busy0: float,
                   service: float) -> Tuple[np.ndarray, float]:
    """Pushes queued behind one PS with a fixed ``service`` time: the
    completion time of each push (in sorted arrival order) and the new
    busy horizon.  ``end_k = service*(k+1) + max_{j<=k}(arr_j -
    service*j)``: one accumulate, no Python loop."""
    if arrivals.size == 0:
        return arrivals, busy0
    arr = np.sort(arrivals)
    arr[0] = max(arr[0], busy0)
    j = np.arange(arr.size, dtype=float)
    end = service * (j + 1.0) + np.maximum.accumulate(arr - service * j)
    return end, float(end[-1])


def _run_hermes_batch(sb: SurrogateBundle, *, num_workers: int,
                      hcfg: HermesConfig, seed: int,
                      init_alloc: Allocation, stop: _StopCfg,
                      alloc_every: float,
                      churn: Optional[ChurnTrace]) -> RunResult:
    """Hermes as wavefronts over flat ``(n,)`` arrays.

    Each pass advances every awake worker by exactly one local iteration;
    the allocator sweeps between wavefronts once ``alloc_every`` simulated
    seconds have passed since its last sweep.  Every worker's state
    (iteration times, data shares, GUP rows, deferred push mass, cluster
    labels, battery) is a numpy column, and metering goes through
    ``Meter.call_batch``, so a wavefront costs O(n) vector ops.  The draws from ``rng``, in order: the diurnal
    phases, then a wavefront's durations, its crashes and downtimes (with
    a failure rate), its losses and its admission."""
    t0 = _time.time()
    n = int(num_workers)
    rng = np.random.default_rng(seed)
    fams = TABLE_II_FAMILIES
    reps = -(-n // len(fams))
    k_base = np.tile(np.array([f[2] for f in fams]), reps)[:n]
    mem_cap = np.tile(np.array([f[3] for f in fams], np.int64), reps)[:n]
    names = [f"{fams[i % len(fams)][0]}_{i}" for i in range(n)]
    meter = Meter()
    wids = meter.worker_ids(names)
    comm = CommModel()
    jitter = 0.06
    eval_n = int(sb.eval_n)
    wire_ratio = _WIRE_RATIO.get(hcfg.compression, 1.0)
    wire_bytes = sb.params_bytes * wire_ratio
    params_bytes = sb.params_bytes
    prate = hcfg.participation_rate
    n_clusters = hcfg.n_clusters
    clustered = n_clusters > 1
    async_rounds = hcfg.async_rounds
    ch = churn.validate() if churn is not None else None

    dss = np.minimum(np.full((n,), init_alloc.dss, np.int64), mem_cap)
    mbs = np.full((n,), init_alloc.mbs, np.int64)
    clock = np.zeros((n,))
    latest_d = np.full((n,), np.nan)
    merge_back = np.zeros((n,))           # async in-flight round trips
    deferred = np.zeros((n,))             # mass awaiting admission
    iters = np.zeros((n,), np.int64)
    pulls = np.zeros((n,), np.int64)
    cluster_of = np.zeros((n,), np.int64)
    gup = _VecGup(n, hcfg)
    progress = 0.0
    ps_busy = 0.0
    ps_updates = 0
    comm_stall = 0.0
    sim_t = 0.0
    meter.call_batch(wids, "data", dss.astype(float) * sb.sample_bytes, 0.0)

    if ch is not None:
        phase = rng.uniform(0.0, max(ch.diurnal_period_s, 1.0), n)
        battery = np.full((n,), ch.battery_s)
        down_until = np.zeros((n,))
        was_down = np.zeros((n,), bool)
    service = 0.004 * max(1.0, eval_n / 64)

    next_sweep = alloc_every

    acc_best, reached, stale = 0.0, False, 0
    history: List[Tuple[float, float]] = []
    rounds = 0
    while True:
        rounds += 1
        # -- availability ---------------------------------------------------
        live = np.ones((n,), bool)
        if ch is not None:
            live &= down_until <= clock
            if ch.diurnal_period_s > 0.0:
                pos = np.mod(clock + phase, ch.diurnal_period_s)
                live &= pos < ch.diurnal_duty * ch.diurnal_period_s
            back_up = was_down & live
            if back_up.any():
                # re-admission: pull + dataset transfer + fresh gate
                # state, Level A's rejoin rule vectorized
                ids = wids[back_up]
                meter.call_batch(ids, "pull", params_bytes,
                                 clock[back_up])
                meter.call_batch(ids, "data",
                                 dss[back_up].astype(float) * sb.sample_bytes,
                                 clock[back_up])
                pulls[back_up] += 1
                gup.reset(back_up)
                deferred[back_up] = 0.0
            was_down = ~live
        if not live.any():
            # everyone asleep: advance toward the next wake-up edge
            clock += 1.0
            sim_t = float(clock.max())
            if sim_t >= stop.max_sim_time:
                break
            continue

        # -- one wavefront of local iterations ------------------------------
        steps = np.maximum(1, dss // np.maximum(1, mbs)).astype(float)
        d = (k_base * steps * np.exp(jitter * rng.standard_normal(n))
             + k_base * 0.35 * max(1.0, eval_n / float(np.median(mbs))))
        start = np.maximum(clock, merge_back) if async_rounds else clock
        if async_rounds:
            comm_stall += float(np.maximum(0.0, merge_back - clock)[live].sum())
        done = start + d
        # idle (down or asleep) workers ride the fleet clock forward, so
        # their recovery edges actually pass
        t_front = float(done[live].max())
        clock = np.where(live, done, np.maximum(clock, t_front))
        latest_d = np.where(live, d, latest_d)
        iters += live
        if ch is not None and ch.battery_s > 0.0:
            battery = np.where(live, battery - d, battery)
            dead_batt = live & (battery <= 0.0)
            down_until = np.where(dead_batt, clock + ch.recharge_s,
                                  down_until)
            battery = np.where(dead_batt, ch.battery_s, battery)
        if ch is not None and ch.failure_rate > 0.0:
            p_crash = 1.0 - np.exp(-ch.failure_rate * d)
            crash = live & (rng.random(n) < p_crash)
            down_until = np.where(
                crash, clock + rng.exponential(ch.mean_downtime_s, n),
                down_until)
        meter.call_batch(wids[live], "telemetry", 64.0, clock[live])

        # -- losses, gate, admission ----------------------------------------
        g_loss = sb.global_loss(progress)
        loss = g_loss * (1.0 + sb.noise * rng.standard_normal(n))
        open_g = gup.update(loss, live)
        admitted = admission_mask(open_g, 1.0 / np.maximum(loss, 1e-9),
                                  prate, mode=hcfg.admission, rng=rng)
        defer = open_g & ~admitted
        if defer.any():
            deferred[defer] += 1.0
            meter.call_batch(wids[defer], "push_deferred", 0.0,
                             clock[defer], n_per=0)
        n_adm = int(admitted.sum())
        if n_adm:
            mass = 1.0 + deferred[admitted]
            deferred[admitted] = 0.0
            meter.call_batch(wids[admitted], "push", wire_bytes,
                             clock[admitted])
            if clustered:
                # one cluster-crossing payload a cluster a wavefront (the
                # slow tier of the cluster merge), billed to the first
                # admitted pusher of each cluster
                cl = cluster_of[admitted]
                _, first = np.unique(cl, return_index=True)
                agg_ids = wids[admitted][first]
                agg_t = clock[admitted][first]
                meter.call_batch(agg_ids, "push_cluster", wire_bytes, agg_t)
                arrivals = agg_t + comm.time(wire_bytes)
            else:
                arrivals = clock[admitted] + comm.time(wire_bytes)
            ends, ps_busy = _serialized_ps(arrivals, ps_busy, service)
            back = float(ends[-1]) + comm.time(params_bytes)
            meter.call_batch(wids[admitted], "pull", params_bytes,
                             clock[admitted])
            pulls[admitted] += 1
            if async_rounds:
                merge_back = np.where(admitted, back, merge_back)
            else:
                stallv = np.maximum(0.0, back - clock[admitted])
                comm_stall += float(stallv.sum())
                clock[admitted] = np.maximum(clock[admitted], back)
            progress += float(mass.sum())
            ps_updates += n_adm

        sim_t = float(clock.max())

        # -- the allocator sweep, once its time has come -------------------
        if next_sweep <= sim_t:
            next_sweep = sim_t + alloc_every
            obs = live & ~np.isnan(latest_d)
            if clustered and obs.any():
                cluster_of[obs] = kmeans_1d_arr(latest_d[obs], n_clusters)
            if int(obs.sum()) < 2:
                meter.call("allocator", "alloc_skip", 0.0, n=0, t=sim_t)
            else:
                lo, hi = 32, max(64, sb.n_train // max(1, int(live.sum())))
                mask, nd, nm = reallocate_arr(
                    latest_d[obs], dss[obs], mbs[obs], hcfg,
                    dss_domain=(lo, hi), mem_limit_arr=mem_cap[obs])
                rows = np.flatnonzero(obs)[mask]
                if rows.size:
                    dss[rows] = np.minimum(nd[mask], mem_cap[rows])
                    mbs[rows] = nm[mask]
                    xfer = dss[rows].astype(float) * sb.sample_bytes
                    meter.call_batch(wids[rows], "data", xfer, sim_t)
                    # prefetch overlaps compute; only the residue stalls
                    clock[rows] = np.maximum(
                        clock[rows], sim_t + comm.time(float(xfer.max())))

        # -- eval / stop ----------------------------------------------------
        if rounds % stop.eval_every == 0 or rounds == 1:
            acc = sb.accuracy(progress)
            history.append((sim_t, acc))
            stale = stale + 1 if acc <= acc_best + 1e-4 else 0
            acc_best = max(acc_best, acc)
            reached = reached or acc >= stop.target_acc
        if _check_stop(acc_best, reached, int(iters.sum()), sim_t, t0, stop,
                       stale):
            break

    if not history:
        acc_best = sb.accuracy(progress)
        history.append((sim_t, acc_best))
    wi = float(np.mean(iters / np.maximum(1, pulls)))
    return RunResult(
        framework="hermes",
        iterations=int(iters.sum()),
        ps_updates=ps_updates,
        sim_time=sim_t,
        wall_time=_time.time() - t0,
        conv_acc=acc_best,
        reached_target=reached,
        target_acc=stop.target_acc,
        api_calls=meter.total_calls,
        bytes_transferred=meter.bytes,
        wi_avg=wi,
        history=history,
        worker_iter_times={},  # left empty at scale (10k x rounds)
        gup_trace=[],
        alloc_trace=[],
        calls_by_kind=dict(meter.calls_by_kind),
        bytes_by_kind=dict(meter.bytes_by_kind),
        meter_events=meter.events,
        comm_stall=comm_stall,
        device="host",  # numpy columns only: no tensor was used
    )


def run_batch(framework: str, bundle: SurrogateBundle, *, num_workers: int,
              hcfg: HermesConfig, seed: int, init_alloc: Allocation,
              stop: _StopCfg, alloc_every: float,
              churn: Optional[ChurnTrace]) -> RunResult:
    if framework != "hermes":
        raise ValueError(
            "the batch/surrogate engine models hermes only; run "
            f"{framework!r} on a real ModelBundle")
    return _run_hermes_batch(bundle, num_workers=num_workers, hcfg=hcfg,
                             seed=seed, init_alloc=init_alloc, stop=stop,
                             alloc_every=alloc_every, churn=churn)
