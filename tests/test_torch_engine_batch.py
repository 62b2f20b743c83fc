"""The port's batch/surrogate fleet engine (``core/engine.py``) on the CPU.

Both packages compute the batch engine in numpy on the host, so the port
is held to the JAX package exactly:

(i) ``run_framework`` with a ``SurrogateBundle`` and a ``ChurnTrace`` in
    both packages, every ``RunResult`` field but ``wall_time`` equal,
    meter events included, over fleet size, participation rate and
    admission, clusters, wire format, async rounds and churn;
(ii) ``_VecGup`` row for row against the scalar ``gup_update``;
(iii) ``_serialized_ps`` against a queue served in a Python loop;
(iv) the reference's behavioural checks: fewer admitted gates push less,
     churn costs time and re-admission pulls, the slow tier is capped,
     the guards, and 10k workers x 200 rounds under 60 s of wall;
(v) ``studies/sim_scale.run(fast=True)`` against the reference's
    ``benchmarks/sim_scale.run(fast=True)``, cell for cell.
"""
import dataclasses
import time

import numpy as np
import pytest

import study_parity as sp

from repro.config import HermesConfig as JHermesConfig
from repro.core import engine as jengine
from repro.core import simulator as jsim

from repro_torch.config import HermesConfig
from repro_torch.core import engine as tengine
from repro_torch.core import simulator as tsim
from repro_torch.core.gup import gup_init, gup_update
from repro_torch.studies import sim_scale

FULL_CHURN = dict(diurnal_period_s=600.0, diurnal_duty=0.8,
                  battery_s=400.0, recharge_s=120.0,
                  failure_rate=1e-4, mean_downtime_s=60.0)


def _both(n, rounds, *, churn=None, seed=11, **cfg):
    """One batch run in each package, at the same settings."""
    out = []
    for run, hc, sb, ct in (
            (jsim.run_framework, JHermesConfig, jengine.SurrogateBundle,
             jengine.ChurnTrace),
            (tsim.run_framework, HermesConfig, tengine.SurrogateBundle,
             tengine.ChurnTrace)):
        kw = dict(num_workers=n, hermes_cfg=hc(**cfg), seed=seed,
                  target_acc=2.0, patience=10 ** 9,
                  max_iterations=rounds * n, max_sim_time=1e9,
                  churn=None if churn is None else ct(**churn))
        if run is tsim.run_framework:
            kw["device"] = "cpu"
        out.append(run("hermes", sb(), **kw))
    return out


# (n, rounds, participation_rate, admission, clusters, compression,
#  async rounds, full churn)
CASES = [
    (100, 60, 1.0, "topk", 1, "none", False, False),
    (100, 60, 1.0, "topk", 1, "none", False, True),
    (100, 60, 0.5, "topk", 1, "none", False, True),
    (100, 60, 0.5, "prob", 1, "none", False, True),
    (100, 60, 1.0, "topk", 8, "none", False, True),
    (100, 60, 1.0, "topk", 1, "int8", False, True),
    (100, 60, 1.0, "topk", 1, "int4", True, True),
    (100, 40, 0.5, "topk", 1, "none", True, False),
    (100, 60, 0.5, "prob", 8, "int4", True, False),
    (1000, 40, 1.0, "topk", 1, "none", False, True),
    (1000, 40, 0.5, "topk", 8, "int8", False, True),
    (1000, 40, 0.5, "prob", 1, "int4", True, True),
    (1000, 40, 1.0, "topk", 8, "none", True, False),
    (1000, 40, 0.5, "prob", 8, "int8", False, True),
]


@pytest.mark.parametrize("n,rounds,prate,admission,clusters,compression,"
                         "async_rounds,churn", CASES)
def test_batch_run_equals_reference(n, rounds, prate, admission, clusters,
                                    compression, async_rounds, churn):
    want, got = _both(n, rounds, churn=FULL_CHURN if churn else None,
                      participation_rate=prate, admission=admission,
                      n_clusters=clusters, compression=compression,
                      async_rounds=async_rounds)
    for f in dataclasses.fields(want):
        if f.name not in ("wall_time", "meter_events"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert list(got.meter_events) == list(want.meter_events)
    assert got.device == "host"
    assert got.iterations > 0 and got.ps_updates > 0
    if prate < 1.0:
        assert got.calls_by_kind.get("push_deferred", 0) == 0
        assert got.bytes_by_kind.get("push_deferred", 1.0) == 0.0
    if clusters > 1:
        assert 0 < got.calls_by_kind["push_cluster"] < got.ps_updates


# ---------------------------------------------------------------------------
# (ii) the vector gate, (iii) the serialized PS
# ---------------------------------------------------------------------------

def test_vecgup_matches_scalar_gup_row_for_row():
    cfg = HermesConfig(alpha=0.1, beta=0.2, lam=3, window=5)
    n, rounds = 16, 40
    rng = np.random.default_rng(9)
    losses = rng.uniform(0.2, 2.0, (rounds, n))
    active = rng.random((rounds, n)) < 0.8
    vec = tengine._VecGup(n, cfg)
    scal = [gup_init(cfg) for _ in range(n)]
    for r in range(rounds):
        pv = vec.update(losses[r], active[r])
        for i in range(n):
            if not active[r, i]:
                assert not pv[i]
                continue
            ps, _ = gup_update(scal[i], float(losses[r, i]))
            assert bool(pv[i]) == ps, (r, i)
            assert vec.alpha[i] == pytest.approx(scal[i].alpha)
    for i in range(n):
        assert int(vec.pushes[i]) == scal[i].pushes


def test_vecgup_reset_restarts_the_rows():
    cfg = HermesConfig(alpha=0.1, beta=0.2, lam=2, window=4)
    vec = tengine._VecGup(3, cfg)
    scal = gup_init(cfg)
    rng = np.random.default_rng(3)
    for _ in range(7):
        vec.update(rng.uniform(0.5, 1.5, 3), np.ones(3, bool))
    vec.reset(np.array([False, True, False]))
    assert vec.cnt[1] == 0 and vec.n_iter[1] == 0
    assert vec.alpha[1] == cfg.alpha and vec.cnt[0] == 7
    # the reset row gates like a fresh scalar gate
    for loss in rng.uniform(0.5, 1.5, 6):
        pv = vec.update(np.full(3, loss), np.ones(3, bool))
        ps, _ = gup_update(scal, float(loss))
        assert bool(pv[1]) == ps


def _queue(arrivals, busy0, service):
    """One server, arrivals in time order, each served for ``service``."""
    ends, busy = [], busy0
    for a in sorted(arrivals):
        busy = max(a, busy) + service
        ends.append(busy)
    return np.array(ends), busy


@pytest.mark.parametrize("m,busy0,service,spread", [
    (0, 3.0, 0.004, 1.0), (1, 0.0, 0.004, 1.0), (1, 5.0, 0.01, 1.0),
    (50, 0.0, 0.004, 1.0), (50, 0.5, 0.004, 0.1), (400, 2.0, 0.016, 5.0),
])
def test_serialized_ps_matches_a_queue(m, busy0, service, spread):
    rng = np.random.default_rng(m)
    arrivals = rng.uniform(0.0, spread, m)
    ends, busy = tengine._serialized_ps(arrivals.copy(), busy0, service)
    want, want_busy = _queue(arrivals, busy0, service)
    np.testing.assert_allclose(ends, want, rtol=1e-12, atol=1e-12)
    assert busy == pytest.approx(want_busy, rel=1e-12, abs=1e-12)
    assert np.all(np.diff(ends) >= service * (1 - 1e-9))


# ---------------------------------------------------------------------------
# (iv) behaviour
# ---------------------------------------------------------------------------

def _scale(n, prate=1.0, churn=None, rounds=60, **cfg_kw):
    hc = HermesConfig(participation_rate=prate, **cfg_kw)
    return tsim.run_framework(
        "hermes", tengine.SurrogateBundle(), num_workers=n, hermes_cfg=hc,
        seed=11, target_acc=2.0, patience=10 ** 9,
        max_iterations=rounds * n, max_sim_time=1e9, churn=churn,
        device="cpu")


def test_batch_admission_monotone_in_prate():
    full, half, quarter = (_scale(400, prate=p) for p in (1.0, 0.5, 0.25))
    assert full.ps_updates > half.ps_updates > quarter.ps_updates
    pushes = [r.bytes_by_kind.get("push", 0.0) for r in (full, half, quarter)]
    assert pushes[0] > pushes[1] > pushes[2]
    assert half.calls_by_kind.get("push_deferred", 1) == 0
    assert half.bytes_by_kind.get("push_deferred", 0.0) == 0.0


def test_batch_churn_costs_time_and_readmission_pulls():
    quiet = _scale(300)
    churned = _scale(300, churn=tengine.ChurnTrace(diurnal_period_s=400.0,
                                                   diurnal_duty=0.5,
                                                   failure_rate=5e-4))
    assert churned.sim_time > 1.5 * quiet.sim_time
    assert quiet.calls_by_kind.get("pull", 0) == quiet.ps_updates
    assert churned.calls_by_kind.get("pull", 0) > churned.ps_updates


def test_batch_clusters_cap_the_slow_tier():
    flat = _scale(512, n_clusters=1)
    cl = _scale(512, n_clusters=8)
    assert cl.calls_by_kind.get("push_cluster", 0) < cl.ps_updates
    assert flat.calls_by_kind.get("push_cluster", 0) == 0


def test_batch_guards():
    with pytest.raises(ValueError):
        tsim.run_framework("hermes", tengine.SurrogateBundle(),
                           engine="legacy", device="cpu")
    with pytest.raises(ValueError):
        tsim.run_framework("bsp", tengine.SurrogateBundle(), device="cpu")
    with pytest.raises(AssertionError):
        _scale(50, churn=tengine.ChurnTrace(diurnal_duty=2.0))


def test_scale_10k_workers_200_rounds_with_churn_under_60s():
    t0 = time.time()
    r = _scale(10_000, prate=0.25, churn=tengine.ChurnTrace(**FULL_CHURN),
               rounds=200, n_clusters=8, compression="int8")
    wall = time.time() - t0
    assert wall < 60.0, wall
    assert r.iterations > 10_000 * 100     # churn keeps some workers out
    assert len(r.meter_events) > 100_000
    ev = r.meter_events
    assert ev[0][2] == "data"
    t, w, kind, nb = ev[len(ev) - 1]
    assert isinstance(kind, str) and nb >= 0.0
    assert r.device == "host"


# ---------------------------------------------------------------------------
# (v) the sweep
# ---------------------------------------------------------------------------

def test_sim_scale_fast_cells_equal_reference():
    ref = sp.load_reference("benchmarks/sim_scale.py")
    want = ref.run(fast=True)
    got = sim_scale.run(fast=True, device="cpu")
    assert got["churn"] == want["churn"]
    assert len(got["cells"]) == len(want["cells"]) == 8
    for g, w in zip(got["cells"], want["cells"]):
        assert {k: v for k, v in g.items() if k != "wall_s"} == \
            {k: v for k, v in w.items() if k != "wall_s"}
        assert g["wall_s"] < 60.0
