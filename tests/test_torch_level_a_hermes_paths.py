"""The port's Level-A Hermes against the JAX package's on its other
paths, whole runs on the CPU: async rounds, two latency clusters, and a
worker that dies and is re-admitted (int4, the reference's dither
injected).  Settings and checks as in ``test_torch_level_a_hermes.py``
(``level_a_parity.check``).
"""
from level_a_parity import HERMES, check


def test_hermes_async_rounds_match_reference(monkeypatch):
    want = check(monkeypatch, dict(HERMES, async_rounds=True))
    assert want.comm_stall < want.sim_time


def test_hermes_two_clusters_match_reference(monkeypatch):
    want = check(monkeypatch, dict(HERMES, n_clusters=2))
    # some pushes piggyback on their cluster's in-flight transfer
    assert 0 < want.calls_by_kind["push_cluster"] < \
        want.calls_by_kind["push"]


def test_hermes_failure_and_rejoin_match_reference(monkeypatch):
    want = check(monkeypatch, dict(HERMES, rejoin_cost_rounds=0.5),
                 failures={"F2s_v2_0": 0.3}, recoveries={"F2s_v2_0": 0.6})
    events = [e for e in want.meter_events if e[1] == "F2s_v2_0"]
    # billed up to its death, nothing while dead, re-admitted at 0.6 with
    # a model pull and a dataset transfer
    assert not [e for e in events if 0.3 <= (e[0] or 0.0) < 0.6]
    assert [k for t, _, k, _ in events if t == 0.6] == ["pull", "data"]
    assert "rejoin_denied" not in want.calls_by_kind
