"""The port's Level-A Hermes against the JAX package's, whole runs on the
CPU, one per wire format: ``none``, ``int8``, and ``int4`` with the
reference's dither injected.

Both packages run ``run_framework("hermes", ...)`` from the same initial
parameters on a 4-worker mnist study that only the iteration cap stops,
with the allocator flagging every worker outside the quartiles
(``iqr_k=0``) so that shards are resized during the run.  The simulated
clock, the counters, ``alloc_trace``, every metered event and the gate's
``(t, worker, push)`` sequence are held exactly; the gate's losses at
``rtol=1e-4`` and the accuracies within two test samples
(``level_a_parity.assert_same_run``, which prints the z-score margins if
a gate decision differs).
"""
import pytest

from level_a_parity import HERMES, check


@pytest.mark.parametrize("compression", ["none", "int8", "int4"])
def test_hermes_run_matches_reference(monkeypatch, compression):
    want = check(monkeypatch, dict(HERMES, compression=compression))
    bill = want.bytes_by_kind["push"] / want.calls_by_kind["push"]
    assert bill == {"none": 423464, "int8": 113022,
                    "int4": 60089}[compression]
