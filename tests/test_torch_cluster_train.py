"""The two-tier trainer's CLI (``--clusters 2``) at lmtiny on the CPU
against the reference's ``train_hermes(n_clusters=2)``."""
import json

import numpy as np
import pytest
import jax

from repro.config import HermesConfig as JHermesConfig
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.launch import train as jtrain
from repro.models import init_lm as jinit_lm

from repro_torch.bridge import from_numpy
from repro_torch.launch import train as ttrain

from torch_parity import jax_noise


@pytest.mark.parametrize("extra", [[], ["--compression", "int8",
                                        "--async-rounds"]])
def test_cli_two_tier_trainer_matches_reference(extra, monkeypatch, capsys):
    """``--clusters 2`` at lmtiny through the CLI, started from the
    reference's init with its int4 noise, against the reference's
    ``train_hermes(n_clusters=2)``: the same gate history and merges, the
    losses within the tolerance of ``tests/test_torch_train.py`` (two
    frameworks' fp32 matmuls)."""
    seed, jcfg = 0, jtrain._preset("lmtiny")
    params0 = jax.device_get(jinit_lm(jcfg, jax.random.PRNGKey(seed))[0])
    monkeypatch.setattr(ttrain, "_init_params",
                        lambda cfg, seed, dev, p0: from_numpy(params0, dev))
    monkeypatch.setattr(ttrain, "GeneratorNoise",
                        lambda seed, dev: jax_noise(seed))
    runs, real = [], ttrain.train_hermes
    monkeypatch.setattr(ttrain, "train_hermes",
                        lambda *a, **kw: runs.append(real(*a, **kw))
                        or runs[-1])
    ttrain.main(["--preset", "lmtiny", "--hermes", "--device", "cpu",
                 "--pods", "4", "--clusters", "2", "--steps", "8",
                 "--batch", "4", "--seq", "32", "--lam", "2", "--alpha",
                 "-0.8", "--lr", "3e-3"] + extra)
    got = runs[-1]
    printed = json.loads(capsys.readouterr().out)
    assert printed["merges"] == got["merges"]
    hcfg = JHermesConfig(alpha=-0.8, beta=0.1, lam=2, eta=1.0, n_clusters=2,
                         compression="int8" if extra else "int4",
                         async_rounds=bool(extra))
    want = jtrain.train_hermes(
        jcfg, steps=8, batch=4, seq=32, pods=4, log_every=10 ** 6,
        opt_cfg=JOptimizerConfig(name="adamw", lr=3e-3), hcfg=hcfg,
        seed=seed)
    assert [(s, g) for s, _, g in got["history"]] == \
        [(s, g) for s, _, g in want["history"]]
    for k in ("merges", "rounds", "dispatched", "committed", "drained"):
        assert got[k] == want[k], k
    assert 0 < got["merges"] < got["rounds"]
    np.testing.assert_allclose([l for _, l, _ in got["history"]],
                               [l for _, l, _ in want["history"]], rtol=1e-4)
    np.testing.assert_allclose(got["global_loss"], want["global_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["pod_losses"], want["pod_losses"],
                               rtol=1e-4)
