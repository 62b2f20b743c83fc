"""The port's Table III study (``repro_torch.studies.table3_convergence``)
against ``benchmarks/table3_convergence.py`` on the CPU, at the parity
settings of ``tests/study_parity.py`` (see ``tests/test_torch_studies.py``,
which holds the other studies the same way)."""
import pytest

import study_parity as sp

from repro_torch.studies import table3_convergence


@pytest.mark.parametrize("dataset,frameworks,cap", [
    ("mnist", None, sp.MAX_ITERATIONS), ("cifar", ["bsp", "hermes"], 12)])
def test_table3_matches_reference(monkeypatch, dataset, frameworks, cap):
    """cifar (non-IID, lam 15, momentum 0.9) is held for 12 iterations:
    its losses grow past 10 and the two packages part at rtol 1e-4 within
    32."""
    rows, runs = sp.study_both(
        monkeypatch, table3_convergence,
        lambda m, kw: m.run(dataset, fast=True, frameworks=frameworks, **kw),
        max_iterations=cap)
    assert [r["framework"] for r in rows] == (
        frameworks or ["bsp", "asp", "ssp", "ebsp", "selsync", "hermes"])
    assert rows[0]["speedup_vs_bsp"] == 1.0 and sp.pushes(runs) > 0
