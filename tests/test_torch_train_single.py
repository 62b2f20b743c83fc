"""The port's single trainer and its CLI against
``repro.launch.train.train_single`` on the CPU: losses from one model,
checkpoints and resumes (a resumed run equals a straight one bit for bit
on the CPU, and a reference checkpoint resumes in the port as in the
reference), and the CLI's defaults."""
import os
import shutil

import numpy as np
import pytest
import torch
import jax

from repro.config import OptimizerConfig as JOptimizerConfig
from repro.launch import train as jtrain
from repro.models import init_lm as jinit_lm

from repro_torch.config import OptimizerConfig
from repro_torch.launch import train as ttrain

RUN = dict(batch=4, seq=32, log_every=10 ** 6, seed=0)


def _params0(seed: int = 0):
    return jax.device_get(jinit_lm(jtrain._preset("lmtiny"),
                                   jax.random.PRNGKey(seed))[0])


def _port(steps, **kw):
    return ttrain.train_single(
        ttrain._preset("lmtiny"), steps=steps,
        opt_cfg=OptimizerConfig(name="adamw", lr=3e-3), device="cpu",
        params0=_params0(), **dict(RUN, **kw))


def _ref(steps, **kw):
    return jtrain.train_single(
        jtrain._preset("lmtiny"), steps=steps,
        opt_cfg=JOptimizerConfig(name="adamw", lr=3e-3), **dict(RUN, **kw))


def _arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return {k: data[k] for k in data.files}


def test_train_single_matches_reference_on_lmtiny():
    want = _ref(8)
    got = _port(8)
    assert got["steps"] == want["steps"] == 8 and len(got["losses"]) == 8
    # the reference's first loss is the port's first, from one model and
    # one batch; the last 10 (here all 8) at rtol 1e-4 as the Hermes
    # trainer's losses (tests/test_torch_train.py)
    np.testing.assert_allclose(got["first_loss"], want["first_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)
    assert got["final_loss"] == float(np.mean(got["losses"]))
    assert got["final_loss"] < got["first_loss"]


def test_resume_equals_a_straight_run_bitwise(tmp_path, capsys):
    straight = _port(8, ckpt_dir=str(tmp_path / "a"))
    first = _port(4, ckpt_dir=str(tmp_path / "b"))
    assert sorted(os.listdir(tmp_path / "b")) == ["step_4"]
    resumed = _port(8, ckpt_dir=str(tmp_path / "b"), restore=True)
    assert "restored from step 4" in capsys.readouterr().out
    assert first["losses"] + resumed["losses"] == straight["losses"]
    a = _arrays(tmp_path / "a" / "step_8")
    b = _arrays(tmp_path / "b" / "step_8")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_reference_checkpoint_resumes_in_the_port(tmp_path, capsys):
    _ref(4, ckpt_dir=str(tmp_path / "ref"))
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    want = _ref(8, ckpt_dir=str(tmp_path / "ref"), restore=True)
    got = ttrain.train_single(
        ttrain._preset("lmtiny"), steps=8,
        opt_cfg=OptimizerConfig(name="adamw", lr=3e-3), device="cpu",
        ckpt_dir=str(tmp_path / "port"), restore=True, **RUN)
    out = capsys.readouterr().out
    assert out.count("restored from step 4") == 2
    assert len(got["losses"]) == 4
    np.testing.assert_allclose(got["first_loss"], want["first_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)
    a = _arrays(tmp_path / "ref" / "step_8")
    b = _arrays(tmp_path / "port" / "step_8")
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_allclose(b[k], a[k], rtol=1e-3, atol=1e-5)


def test_restore_past_the_end_reports_nan(tmp_path):
    _port(4, ckpt_dir=str(tmp_path))
    out = _port(2, ckpt_dir=str(tmp_path), restore=True)
    assert np.isnan(out["final_loss"]) and np.isnan(out["first_loss"])
    assert out["losses"] == [] and out["steps"] == 2
    want = _ref(2, ckpt_dir=str(tmp_path), restore=True)
    assert np.isnan(want["final_loss"]) and np.isnan(want["first_loss"])


def test_cli_defaults_and_flags(monkeypatch, capsys):
    calls = []

    def fake(name):
        def run(cfg, **kw):
            calls.append((name, cfg.name, kw))
            return {"steps": kw["steps"], "history": [], "losses": []}
        return run

    monkeypatch.setattr(ttrain, "train_single", fake("single"))
    monkeypatch.setattr(ttrain, "train_hermes", fake("hermes"))
    ttrain.main([])
    name, preset, kw = calls[-1]
    assert (name, preset) == ("single", "lmtiny")
    assert {k: kw[k] for k in ("steps", "batch", "seq", "ckpt_dir",
                               "restore", "seed", "device")} == {
        "steps": 100, "batch": 8, "seq": 128, "ckpt_dir": None,
        "restore": False, "seed": 0, "device": "cuda"}
    assert kw["opt_cfg"] == OptimizerConfig(name="adamw", lr=3e-4)
    ttrain.main(["--hermes", "--participation-rate", "0.5", "--admission",
                 "prob", "--ckpt", "/nonexistent/ck", "--device", "cpu"])
    name, _, kw = calls[-1]
    hcfg = kw["hcfg"]
    assert name == "hermes" and kw["pods"] == 4 and kw["device"] == "cpu"
    assert kw["ckpt_dir"] == "/nonexistent/ck"
    assert (hcfg.participation_rate, hcfg.admission, hcfg.n_clusters,
            hcfg.compression, hcfg.lam) == (0.5, "prob", 1, "int4", 5)
    assert '"compression": "int4"' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        ttrain.main(["--hermes", "--clusters", "2"])
    assert "ROADMAP queue 1 item 5" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        ttrain.main(["--hermes", "--admission", "fifo"])
    with pytest.raises(ValueError, match="participation_rate"):
        ttrain.main(["--hermes", "--participation-rate", "0"])


def test_cli_checkpoints_and_restores(tmp_path, capsys):
    common = ["--device", "cpu", "--batch", "2", "--seq", "16", "--ckpt",
              str(tmp_path)]
    ttrain.main(["--steps", "10"] + common)
    assert sorted(os.listdir(tmp_path)) == ["step_10"]
    capsys.readouterr()
    ttrain.main(["--steps", "20", "--restore"] + common)
    out = capsys.readouterr().out
    assert "restored from step 10" in out and "step    20 loss" in out
    assert sorted(os.listdir(tmp_path)) == ["step_10", "step_20"]


def test_train_single_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.train_single(ttrain._preset("lmtiny"), steps=1, batch=1,
                            seq=8, opt_cfg=OptimizerConfig())
