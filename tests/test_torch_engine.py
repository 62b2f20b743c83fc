"""The port's ``engine="vector"`` on the CPU.

The reference's exact slot scheduler gives the legacy loops' runs; in the
port it is those loops, plus Level-A participation admission
(``participation_rate < 1`` under ``prob``), which the reference's legacy
loop ignores.

(i) The dispatch: without admission to draw, ``engine="vector"`` is the
``engine="legacy"`` run field for field (meter events included, wall time
excepted), and the legacy loop ignores the rate as the reference's does.

(ii) Against the JAX package's own vector engine at the whole-run parity
settings (``level_a_parity``: 4 workers, one SGD step an iteration, 32-40
iterations), through ``assert_same_run``: BSP (also under a failure),
ASP with a failure, SSP, SelSync, Hermes int4 with the reference's
dither, Hermes with failure, re-admission and non-IID redraws, Hermes
with async rounds and two clusters, and Hermes at
``participation_rate=0.5`` under ``prob`` admission, which has no legacy
oracle.
"""
import dataclasses

import pytest
import torch

from level_a_parity import HERMES, assert_same_run, check, run_both

from repro_torch.config import HermesConfig
from repro_torch.core import simulator as tsim
from repro_torch.core.allocator import Allocation
from repro_torch.core.bundles import make_paper_bundle

#: every field of a run but its wall time
FIELDS = [f.name for f in dataclasses.fields(tsim.RunResult)
          if f.name not in ("wall_time", "meter_events")]


# ---------------------------------------------------------------------------
# (i) the dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hermes", [
    dict(compression="int4"),                                 # rate 1
    dict(compression="int4", participation_rate=0.5, admission="topk"),
], ids=["rate1", "topk"])
def test_vector_without_admission_is_the_legacy_run(hermes):
    """Admission draws only under ``prob`` below rate 1: otherwise the
    vector entry leaves every stream, and so the run, as legacy's."""
    bundle, _ = make_paper_bundle("mnist", n=600, eval_batch=32)
    args = dict(num_workers=4, target_acc=1.01, max_wall=1e9,
                patience=10 ** 6, init_alloc=Allocation(16, 16),
                max_iterations=32, alloc_every=0.3, device="cpu",
                hermes_cfg=HermesConfig(**dict(HERMES, **hermes)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        a = tsim.run_framework("hermes", bundle, engine="legacy", **args)
        b = tsim.run_framework("hermes", bundle, engine="vector", **args)
    finally:
        torch.set_num_threads(threads)
    for f in FIELDS:
        assert getattr(b, f) == getattr(a, f), f
    assert list(b.meter_events) == list(a.meter_events)
    assert "push_deferred" not in a.calls_by_kind
    assert 0 < a.calls_by_kind["push"] < a.iterations


def test_legacy_ignores_the_participation_rate(monkeypatch):
    """The legacy loop at rate 0.5 ``prob`` is the reference's legacy run:
    every open gate ships."""
    want = check(monkeypatch, dict(HERMES, participation_rate=0.5,
                                   admission="prob"), engine="legacy")
    assert "push_deferred" not in want.calls_by_kind
    assert want.calls_by_kind["push"] == sum(p for *_, p in want.gup_trace)


# ---------------------------------------------------------------------------
# (ii) the port's vector engine against the reference's
# ---------------------------------------------------------------------------

BASELINES = {
    "bsp": ("bsp", {}),
    "bsp-failure": ("bsp", dict(failures={"F2s_v2_0": 0.3})),
    "asp-failure": ("asp", dict(failures={"F2s_v2_0": 0.3})),
    "ssp": ("ssp", dict(ssp_s=1)),   # the staleness gate closes
    "selsync": ("selsync", {}),
}


@pytest.mark.parametrize("case", list(BASELINES))
def test_vector_baseline_matches_reference(monkeypatch, case):
    framework, kw = BASELINES[case]
    want, got, n_test = run_both(monkeypatch, framework, engine="vector",
                                 max_iterations=40, **kw)
    assert_same_run(want, got, n_test)
    # a BSP round after the death adds 3 iterations: the cap is passed
    assert 40 <= want.iterations < 44 and want.ps_updates > 1
    if "failures" in kw:  # pushed before its death, never after
        pushes = [t for t, w, k, _ in want.meter_events
                  if w == "F2s_v2_0" and k == "push"]
        assert pushes and max(pushes) < 0.3 + 1e-9
    if framework == "selsync":  # both of its paths: syncs and telemetry
        assert want.calls_by_kind["telemetry"] > 0
        assert 0 < want.calls_by_kind["push"] < want.iterations


def test_vector_hermes_int4_matches_reference(monkeypatch):
    want = check(monkeypatch, dict(HERMES, compression="int4",
                                   error_feedback=True), engine="vector")
    assert want.bytes_by_kind["push"] == \
        60089 * want.calls_by_kind["push"]


def test_vector_hermes_failure_rejoin_noniid_matches_reference(monkeypatch):
    """A death mid-run, a re-admission (median-seeded) and Dirichlet
    partition redraws in the sweep."""
    want = check(monkeypatch, dict(HERMES, rejoin_cost_rounds=0.5),
                 engine="vector", noniid=True,
                 failures={"F2s_v2_0": 0.3}, recoveries={"F2s_v2_0": 0.6})
    events = [e for e in want.meter_events if e[1] == "F2s_v2_0"]
    assert not [e for e in events if 0.3 <= (e[0] or 0.0) < 0.6]
    assert [k for t, _, k, _ in events if t == 0.6] == ["pull", "data"]


def test_vector_hermes_async_two_clusters_matches_reference(monkeypatch):
    want = check(monkeypatch, dict(HERMES, async_rounds=True, n_clusters=2),
                 engine="vector")
    assert 0 < want.calls_by_kind["push_cluster"] < \
        want.calls_by_kind["push"]
    assert want.comm_stall < want.sim_time


def test_vector_hermes_prob_admission_matches_reference(monkeypatch):
    """Level-A admission exists only in the vector engine: the reference's
    vector engine is the oracle.  Deferred pushes are billed nothing and
    are no PS contact; the admitted ones are the pushes."""
    want = check(monkeypatch, dict(HERMES, compression="int4",
                                   participation_rate=0.5,
                                   admission="prob"),
                 engine="vector")
    opened = sum(p for *_, p in want.gup_trace)
    deferred = [e for e in want.meter_events if e[2] == "push_deferred"]
    assert deferred and all(e[3] == 0.0 for e in deferred)
    assert "push_deferred" in want.calls_by_kind
    assert want.calls_by_kind["push_deferred"] == 0
    assert want.calls_by_kind["push"] + len(deferred) == opened
