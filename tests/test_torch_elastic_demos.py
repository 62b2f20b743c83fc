"""The port's two-tier resize cycle and the elastic demos against
``repro.launch.elastic`` on the CPU: ``tests/test_cluster.py``'s resize
cycle, each harness bitwise within the port, and the three demos' reports
key for key (the mesh fields become group sizes).
"""
import json

import pytest

from repro.config import HermesConfig as JHermesConfig
from repro.launch import elastic as jel

from repro_torch.config import HermesConfig
from repro_torch.launch import elastic as tel


def test_cluster_resize_cycles_bit_identical():
    """shrink -> grow -> shrink over 3 cycles leaves no scar: every row
    bitwise the never-resized oracle per cycle (``tests/test_cluster.py``'s
    pin at its int8 default, the demo's configuration)."""
    out = tel.run_hermes_cluster_resize_demo(device="cpu")
    assert out == jel.run_hermes_cluster_resize_demo()
    assert out["bit_identical"] is True and out["cycles"] == 3
    assert out["shrunk_cluster_sizes"] == [2, 1]


def test_cluster_resize_cycles_lossless_wire():
    kw = dict(alpha=-0.5, beta=0.1, lam=2, window=4, compression="none",
              min_live_pods=1, rejoin_cost_rounds=0.0, n_clusters=2)
    out = tel.cluster_resize_cycle_equivalence(
        cycles=3, cfg=HermesConfig(**kw), device="cpu")
    assert out == jel.cluster_resize_cycle_equivalence(
        cycles=3, cfg=JHermesConfig(**kw))


def test_demos_report_as_the_reference():
    """The shrink and rejoin demos at 2 pods (the reference caps its pod
    count at its device count; the port takes it as given): every key of
    the reference but the mesh fields, which become group sizes (None
    unplaced)."""
    mesh = {"mesh", "survivor_mesh", "shrunk_mesh", "regrown_mesh"}
    for name in ("shrink", "rejoin"):
        got = getattr(tel, f"run_hermes_{name}_demo")(n_pods=2, device="cpu")
        want = getattr(jel, f"run_hermes_{name}_demo")(n_pods=2)
        for k in set(want) - mesh:
            assert got[k] == want[k], (name, k)
        for k in set(got) - set(want):
            assert got[k] is None, (name, k)


def test_main_names_the_unported_checkpoint_restart(capsys):
    tel.main(["--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert {"hermes_shrink", "hermes_rejoin", "hermes_cluster_resize"} <= \
        set(out)
    assert out["hermes_rejoin"]["bit_identical"]
    assert "ROADMAP queue 1 item 9" in out["checkpoint_restart"]["error"]
    with pytest.raises(NotImplementedError, match="item 9"):
        tel.run_demo()
