"""The port's Level-A simulator against the JAX package's, whole runs of
the baselines on the CPU: BSP, ASP, SSP, EBSP and SelSync.

Both packages run ``run_framework`` from the same initial parameters on
a 4-worker mnist study (``level_a_parity.RUN``) that only the iteration
cap stops.  The simulated clock, the counters, the traces and every
metered event are held exactly, the accuracies within two test samples
(``level_a_parity.assert_same_run``).
"""
import pytest

from level_a_parity import assert_same_run, run_both

BASELINES = {
    "bsp": {},
    "asp": {},
    "ssp": dict(ssp_s=1),        # the staleness gate closes
    "ebsp": dict(ebsp_r=3),      # a short lookahead: several barriers
    "selsync": {},
}


@pytest.mark.parametrize("framework", list(BASELINES))
def test_baseline_run_matches_reference(monkeypatch, framework):
    want, got, n_test = run_both(monkeypatch, framework, max_iterations=40,
                                 **BASELINES[framework])
    assert_same_run(want, got, n_test)
    assert want.iterations == 40 and want.ps_updates > 1
    assert len(want.history) > 2
    if framework == "selsync":  # both of its paths: syncs and telemetry
        assert want.calls_by_kind["telemetry"] > 0
        assert 0 < want.calls_by_kind["push"] < want.iterations
