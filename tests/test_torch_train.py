"""The port's Hermes trainer against ``repro.launch.train.train_hermes`` on
the CPU, plus the port's import boundary and device default."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax

from repro.config import HermesConfig as JHermesConfig
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.launch import train as jtrain
from repro.models import init_lm as jinit_lm

from repro_torch.config import HermesConfig, OptimizerConfig
from repro_torch.launch import train as ttrain

from torch_parity import jax_noise

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("compression", ["none", "int4"])
def test_train_hermes_matches_reference_on_lmtiny(compression):
    seed = 0
    run = dict(steps=8, batch=4, seq=32, pods=3, log_every=10 ** 6, seed=seed)
    hkw = dict(alpha=-0.8, beta=0.1, lam=2, eta=1.0, compression=compression)
    want = jtrain.train_hermes(
        jtrain._preset("lmtiny"), opt_cfg=JOptimizerConfig(name="adamw",
                                                           lr=3e-3),
        hcfg=JHermesConfig(**hkw), **run)
    params0 = jax.device_get(
        jinit_lm(jtrain._preset("lmtiny"), jax.random.PRNGKey(seed))[0])
    got = ttrain.train_hermes(
        ttrain._preset("lmtiny"), opt_cfg=OptimizerConfig(name="adamw",
                                                          lr=3e-3),
        hcfg=HermesConfig(**hkw), device="cpu", params0=params0,
        noise=jax_noise(seed), **run)
    assert [(s, g) for s, _, g in got["history"]] == \
        [(s, g) for s, _, g in want["history"]]
    assert (got["merges"], got["rounds"]) == (want["merges"], want["rounds"])
    assert 0 < got["merges"] < got["rounds"]
    np.testing.assert_allclose([l for _, l, _ in got["history"]],
                               [l for _, l, _ in want["history"]], rtol=1e-4)
    np.testing.assert_allclose(got["global_loss"], want["global_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["pod_losses"], want["pod_losses"],
                               rtol=1e-4)


def test_train_hermes_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.train_hermes(ttrain._preset("lmtiny"), steps=1, batch=1, seq=8,
                            pods=1, opt_cfg=OptimizerConfig(),
                            hcfg=HermesConfig())


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
