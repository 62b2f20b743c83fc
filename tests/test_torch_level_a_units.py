"""The port's Level-A host side against the JAX package, one piece at a
time, on the CPU: the configuration, the allocator, the host gate, the
synthetic data and the loader, the cluster's clock and meter; and the
refusals of ``run_framework``.

Inputs are made with numpy from a seed and handed to both sides; both
sides compute these in numpy, so they are held exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax

from repro.config import HermesConfig as JHermesConfig
from repro.core import allocator as jalloc
from repro.core import bundles as jbundles
from repro.core import cluster as jcluster
from repro.core import gup as jgup
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn

from repro_torch import bridge
from repro_torch.config import HermesConfig
from repro_torch.core import allocator as talloc
from repro_torch.core import bundles as tbundles
from repro_torch.core import cluster as tcluster
from repro_torch.core import gup as tgup
from repro_torch.core import simulator as tsim
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn

# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def test_hermes_config_defaults_match_reference():
    want = dataclasses.asdict(JHermesConfig())
    got = dataclasses.asdict(HermesConfig())
    assert got == want
    for bad in (dict(failure_timeout_factor=0.0), dict(min_live_pods=0),
                dict(rejoin_cost_rounds=-1.0)):
        with pytest.raises(ValueError):
            HermesConfig(**bad).validate()


# ---------------------------------------------------------------------------
# the allocator: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 12, 50])
@pytest.mark.parametrize("k", [0.0, 1.5])
def test_outlier_fences_match_reference(n, k):
    rng = np.random.default_rng(n)
    times = rng.lognormal(0.0, 0.6, n)
    times[0] *= 4.0  # a straggler
    named = {f"w{i}": float(t) for i, t in enumerate(times)}
    np.testing.assert_array_equal(talloc.detect_outliers_arr(times, k),
                                  jalloc.detect_outliers_arr(times, k))
    assert talloc.detect_outliers(named, k) == jalloc.detect_outliers(named,
                                                                      k)
    if n:
        assert talloc.quartiles(times) == jalloc.quartiles(times)


@pytest.mark.parametrize("seed", range(4))
def test_dual_binary_search_and_model_match_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        k = float(rng.uniform(0.005, 0.08))
        target = float(rng.uniform(0.05, 3.0))
        dom = (int(rng.integers(16, 64)), int(rng.integers(64, 4000)))
        mem = int(rng.integers(40, 10 ** 4))
        epochs = int(rng.integers(1, 3))
        want = jalloc.dual_binary_search(k, target, epochs=epochs,
                                         dss_domain=dom, mem_limit_dss=mem)
        got = talloc.dual_binary_search(k, target, epochs=epochs,
                                        dss_domain=dom, mem_limit_dss=mem)
        assert (got.dss, got.mbs) == (want.dss, want.mbs)
        assert got.steps_per_iteration == want.steps_per_iteration
        dss, mbs = int(rng.integers(16, 600)), int(rng.choice([4, 16, 64]))
        assert talloc.estimate_k(target, epochs, dss, mbs) == \
            jalloc.estimate_k(target, epochs, dss, mbs)
        assert talloc.predicted_time(k, epochs, dss, mbs) == \
            jalloc.predicted_time(k, epochs, dss, mbs)


@pytest.mark.parametrize("target", ["median", "mean"])
@pytest.mark.parametrize("n", [2, 3, 6, 12])
def test_reallocate_matches_reference(target, n):
    rng = np.random.default_rng(n)
    names = [f"w{i}" for i in range(n)]
    times = {w: float(t) for w, t in zip(names, rng.lognormal(0, 0.7, n))}
    times[names[-1]] *= 6.0
    dss = rng.integers(32, 512, n)
    mbs = rng.choice([8, 16, 32], n)
    mem = {w: int(m) for w, m in zip(names, rng.integers(100, 3000, n))}
    jcfg, tcfg = (C(iqr_k=0.5, target=target)
                  for C in (JHermesConfig, HermesConfig))
    want = jalloc.reallocate(
        times, {w: jalloc.Allocation(int(d), int(m))
                for w, d, m in zip(names, dss, mbs)}, jcfg,
        dss_domain=(32, 400), mem_limit_dss=mem)
    got = talloc.reallocate(
        times, {w: talloc.Allocation(int(d), int(m))
                for w, d, m in zip(names, dss, mbs)}, tcfg,
        dss_domain=(32, 400), mem_limit_dss=mem)
    assert {w: (a.dss, a.mbs) for w, a in got.items()} == \
        {w: (a.dss, a.mbs) for w, a in want.items()}
    vals = np.asarray(list(times.values()))
    lim = np.asarray(list(mem.values()), np.int64)
    for a, b in zip(talloc.reallocate_arr(vals, dss, mbs, tcfg,
                                          dss_domain=(32, 400),
                                          mem_limit_arr=lim),
                    jalloc.reallocate_arr(vals, dss, mbs, jcfg,
                                          dss_domain=(32, 400),
                                          mem_limit_arr=lim)):
        np.testing.assert_array_equal(a, b)
    k_arr = rng.uniform(0.005, 0.08, n)
    for a, b in zip(talloc.allocate_batch(k_arr, 0.7, mem_limit_arr=lim),
                    jalloc.allocate_batch(k_arr, 0.7, mem_limit_arr=lim)):
        np.testing.assert_array_equal(a, b)


def test_readmission_policy_matches_reference():
    for cost in (0.0, 0.5, 2.0, 7.5):
        jcfg, tcfg = JHermesConfig(rejoin_cost_rounds=cost), \
            HermesConfig(rejoin_cost_rounds=cost)
        for n_live in (0, 1, 3, 11):
            for rem in (0.0, 1.0, 7.9, 8.0, 30.0, 400.0):
                assert talloc.rejoin_gain_rounds(n_live, rem) == \
                    jalloc.rejoin_gain_rounds(n_live, rem)
                assert talloc.should_readmit(rem, n_live, tcfg) == \
                    jalloc.should_readmit(rem, n_live, jcfg)


@pytest.mark.parametrize("mode,prate", [("topk", 0.5), ("topk", 1.0),
                                        ("topk", 0.1), ("prob", 0.4)])
def test_admission_mask_matches_reference(mode, prate):
    rng = np.random.default_rng(5)
    open_mask = rng.random(40) < 0.6
    weights = np.round(rng.random(40), 1)  # ties: the index breaks them
    want = jalloc.admission_mask(open_mask, weights, prate, mode,
                                 rng=np.random.default_rng(9))
    got = talloc.admission_mask(open_mask, weights, prate, mode,
                                rng=np.random.default_rng(9))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,n_clusters", [(0, 2), (1, 3), (3, 3), (8, 1),
                                          (8, 2), (12, 3), (30, 4)])
def test_kmeans_matches_reference(n, n_clusters):
    rng = np.random.default_rng(n + n_clusters)
    vals = np.round(rng.lognormal(0, 0.8, n), 2)  # ties on purpose
    times = {f"w{i:02d}": float(v) for i, v in enumerate(vals)}
    got = talloc.kmeans_1d(times, n_clusters)
    assert got == jalloc.kmeans_1d(times, n_clusters)
    np.testing.assert_array_equal(talloc.kmeans_1d_arr(vals, n_clusters),
                                  jalloc.kmeans_1d_arr(vals, n_clusters))
    assert talloc.cluster_sizes(got, n_clusters) == \
        jalloc.cluster_sizes(got, n_clusters)


# ---------------------------------------------------------------------------
# the host gate: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(alpha=-1.3, beta=0.4, lam=2, window=5),   # decays to the 0 clamp
    dict(alpha=-5.0, beta=0.1, lam=3, window=4),   # alpha_min clamp
    dict(alpha=-0.3, beta=0.2, lam=1, window=10, alpha_max=-0.1),
])
def test_host_gate_matches_reference_over_a_loss_stream(cfg):
    rng = np.random.default_rng(2)
    # a falling loss with noise, a plateau (decays), a constant stretch
    # (zero spread: z is +inf) and sharp drops (pushes)
    losses = np.concatenate([2.0 - 0.05 * np.arange(12)
                             + 0.05 * rng.standard_normal(12),
                             np.full(6, 1.5), [0.4, 1.4, 1.45, 0.3],
                             1.4 + 0.1 * rng.standard_normal(14)])
    js, ts = jgup.gup_init(JHermesConfig(**cfg)), \
        tgup.gup_init(HermesConfig(**cfg))
    decays = 0
    for x in losses.tolist():
        assert tgup.zscore(ts.queue, x) == jgup.zscore(js.queue, x)
        before = ts.alpha
        pj, js = jgup.gup_update(js, x)
        pt, ts = tgup.gup_update(ts, x)
        assert pt == pj
        assert ts.snapshot() == js.snapshot()
        decays += ts.alpha != before
    assert 0 < ts.pushes < len(losses) and decays > 0


# ---------------------------------------------------------------------------
# the data: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,difficulty,label_noise", [
    ((28, 28, 1), 0.35, 0.0), ((32, 32, 3), 0.9, 0.1)])
def test_image_dataset_split_and_partitions_match_reference(
        shape, difficulty, label_noise):
    kw = dict(seed=4, difficulty=difficulty, label_noise=label_noise)
    want = jsyn.make_image_dataset(257, shape, 10, **kw)
    got = tsyn.make_image_dataset(257, shape, 10, **kw)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for a, b in zip(tsyn.train_test_split(got, 0.15, seed=4),
                    jsyn.train_test_split(want, 0.15, seed=4)):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    for workers in (1, 5, 12):
        for a, b in zip(tsyn.iid_partition(257, workers, seed=2),
                        jsyn.iid_partition(257, workers, seed=2)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(
                tsyn.dirichlet_partition(got["labels"], workers, seed=2),
                jsyn.dirichlet_partition(want["labels"], workers, seed=2)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_sharded_loader_matches_reference_across_resizes():
    data = {"x": np.arange(200, dtype=np.float32).reshape(100, 2),
            "y": np.arange(100, dtype=np.int32)}
    kw = dict(seed=7, indices=np.arange(10, 70))
    jl, tl = jpipe.ShardedLoader(data, 16, **kw), \
        tpipe.ShardedLoader(data, 16, **kw)
    plan = [None] * 5 + [("batch", 7)] * 4 + [("idx", np.arange(0, 100, 3))] \
        + [None] * 6 + [("batch", 40), ("idx", np.arange(90, 97))] \
        + [None] * 3
    for step in plan:
        if step is not None:
            kind, arg = step
            for ld in (jl, tl):
                ld.set_batch(arg) if kind == "batch" else ld.set_indices(arg)
        a, b = next(tl), next(jl)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
        assert tl.epoch_steps() == jl.epoch_steps()


def test_prefetcher_keeps_the_loaders_order():
    data = {"x": np.arange(64, dtype=np.float32)}
    want = tpipe.ShardedLoader(data, 8, seed=1)
    pf = tpipe.Prefetcher(tpipe.ShardedLoader(data, 8, seed=1), "cpu",
                          depth=2)
    try:
        for _ in range(12):
            np.testing.assert_array_equal(next(pf)["x"].numpy(),
                                          next(want)["x"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# the cluster: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4, 6, 12, 17])
def test_default_cluster_and_comm_model_match_reference(n):
    for degrade in (True, False):
        got = [dataclasses.asdict(s)
               for s in tcluster.default_cluster(n, degrade_one=degrade)]
        want = [dataclasses.asdict(s)
                for s in jcluster.default_cluster(n, degrade_one=degrade)]
        assert got == want
    for nb in (0.0, 64.0, 423464.0, 3993000.0):
        assert tcluster.CommModel().time(nb) == jcluster.CommModel().time(nb)
        assert tcluster.CommModel(0.01, 1e8).time(nb) == \
            jcluster.CommModel(0.01, 1e8).time(nb)


def test_meter_matches_reference():
    rng = np.random.default_rng(0)
    meters = jcluster.Meter(), tcluster.Meter()
    kinds = ["push", "pull", "data", "telemetry", "rejoin_denied"]
    for i in range(300):
        w, kind = f"w{rng.integers(0, 7)}", kinds[rng.integers(0, 5)]
        nb, t = float(rng.integers(0, 10 ** 6)), \
            (None if i % 11 == 0 else float(rng.random()))
        n = 0 if kind == "rejoin_denied" else int(rng.integers(1, 3))
        for m in meters:
            m.call(w, kind, nb, n=n, t=t)
    # a cohort that crosses an event chunk
    for m in meters:
        wids = m.worker_ids([f"c{i % 50}" for i in range(70000)])
        m.call_batch(wids, "push", np.arange(70000.0), 2.5, n_per=2)
    a, b = meters[1], meters[0]
    assert (a.bytes, a.calls_by_kind, a.bytes_by_kind, a.api_calls,
            a.total_calls) == (b.bytes, b.calls_by_kind, b.bytes_by_kind,
                               b.api_calls, b.total_calls)
    assert len(a.events) == len(b.events) == 70300
    assert list(a.events) == list(b.events)
    assert a.events[-3:] == b.events[-3:] and a.events[5] == b.events[5]


def test_worker_clock_matches_reference():
    """The simulated iteration times of one worker through allocation
    changes and a drifting clock: the same numpy draws, exactly."""
    spec = jcluster.default_cluster(1)[0]
    jb, _ = jbundles.make_paper_bundle("mnist", n=120)
    tb, _ = tbundles.make_paper_bundle("mnist", n=120)
    p0 = jax.device_get(jb.init(jax.random.PRNGKey(0)))
    idx = np.arange(40)
    jw = jcluster.EdgeWorker(spec, p0, idx, jalloc.Allocation(32, 8), jb,
                             None, 3)
    tspec = tcluster.WorkerSpec(**dataclasses.asdict(spec))
    tw = tcluster.EdgeWorker(tspec, bridge.from_numpy(p0, "cpu"), idx,
                             talloc.Allocation(32, 8), tb, None, 3,
                             {k: torch.as_tensor(v)
                              for k, v in tb.train_data.items()})
    for i in range(30):
        if i == 10:
            jw.set_allocation(jalloc.Allocation(64, 16), np.arange(80))
            tw.set_allocation(talloc.Allocation(64, 16), np.arange(80))
        jw.clock = tw.clock = 100.0 * i
        assert tw.sim_iteration_time(64) == jw.sim_iteration_time(64)
        assert tw.k_now() == jw.k_now()
        want = next(jw.loader)
        for k, v in tw.next_batch().items():
            np.testing.assert_array_equal(v.numpy(), want[k])


# ---------------------------------------------------------------------------
# the entry point's refusals
# ---------------------------------------------------------------------------

def _tiny_bundle():
    tb, _ = tbundles.make_paper_bundle("mnist", n=60, eval_batch=8)
    return tb


def test_run_framework_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tsim.run_framework("hermes", _tiny_bundle(), num_workers=2,
                           max_iterations=1)


#: (framework, bundle: "real" or "surrogate", keyword arguments) of every
#: refusal of the engine dispatch, and of ``ChurnTrace.validate``
GUARDS = {
    "legacy_with_a_surrogate": ("hermes", "surrogate",
                                dict(engine="legacy")),
    "legacy_with_churn": ("hermes", "real",
                          dict(engine="legacy", churn=dict())),
    "churn_with_a_real_bundle": ("hermes", "real", dict(churn=dict())),
    "batch_with_failures": ("hermes", "surrogate",
                            dict(failures={"B1ms_0": 1.0})),
    "batch_with_recoveries": ("hermes", "surrogate",
                              dict(recoveries={"B1ms_0": 2.0})),
    "batch_not_hermes": ("bsp", "surrogate", {}),
    "ebsp_on_the_vector_engine": ("ebsp", "real", dict(engine="vector")),
    "unknown_framework_on_the_vector_engine": ("gossip", "real",
                                               dict(engine="vector")),
    "unknown_engine": ("hermes", "real", dict(engine="fast")),
    "churn_duty_above_one": ("hermes", "surrogate",
                             dict(churn=dict(diurnal_duty=2.0))),
    "churn_recharge_zero": ("hermes", "surrogate",
                            dict(churn=dict(battery_s=10.0,
                                            recharge_s=0.0))),
}


@pytest.mark.parametrize("case", list(GUARDS))
def test_run_framework_guards_match_reference(case):
    """Each bad combination of engine, bundle, churn trace, failures and
    framework raises in the port what it raises in the reference, with
    the same message."""
    from repro.core import engine as jengine
    from repro.core import simulator as jsim
    from repro_torch.core import engine as tengine
    framework, kind, kw = GUARDS[case]
    caught = []
    for run, engine, bundles, extra in (
            (jsim.run_framework, jengine, jbundles, {}),
            (tsim.run_framework, tengine, tbundles, dict(device="cpu"))):
        bundle = engine.SurrogateBundle() if kind == "surrogate" else \
            bundles.make_paper_bundle("mnist", n=60, eval_batch=8)[0]
        args = dict(kw, **extra)
        if "churn" in args:
            args["churn"] = engine.ChurnTrace(**args["churn"])
        with pytest.raises((ValueError, AssertionError)) as err:
            run(framework, bundle, num_workers=2, max_iterations=1, **args)
        caught.append(err)
    want, got = caught
    assert got.type is want.type
    assert str(got.value) == str(want.value)


def test_run_framework_refuses_other_bundles_and_bad_arguments():
    from repro_torch.core.engine import SurrogateBundle

    # the surrogate bundle models hermes only
    with pytest.raises(ValueError, match="hermes only"):
        tsim.run_framework("asp", SurrogateBundle(), device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tsim.run_framework("hermes", _tiny_bundle(), engine="fast",
                           device="cpu")
    kw = dict(num_workers=2, device="cpu", max_iterations=1)
    with pytest.raises(ValueError, match="without a failure"):
        tsim.run_framework("hermes", _tiny_bundle(),
                           recoveries={"B1ms_0": 1.0}, **kw)
    with pytest.raises(ValueError, match="only hermes"):
        tsim.run_framework("bsp", _tiny_bundle(), failures={"B1ms_0": 1.0},
                           recoveries={"B1ms_0": 2.0}, **kw)
    with pytest.raises(KeyError):
        tsim.run_framework("gossip", _tiny_bundle(), **kw)
