"""The port's examples (``repro_torch.examples``) against the JAX package's
``examples/`` on the CPU: the two Level-A examples at the parity settings
of ``tests/study_parity.py`` (their printout and report equal), and
``multi_pod_hermes`` (the single trainer, then Hermes at lmtiny) with both
trainers cut to 16 steps and started from one model, and ``serve_decode``
(the three smoke configs served)."""
import json
import re

import numpy as np
import jax

from repro.launch import train as jtrain
from repro.models import init_lm as jinit_lm

import study_parity as sp
from repro_torch.examples import (
    multi_pod_hermes, quickstart, serve_decode, train_hermes_cluster,
)

from torch_parity import jax_noise


def _printed(capsys, main, *args):
    main(*args)
    return capsys.readouterr().out


def test_quickstart_matches_reference(monkeypatch, capsys):
    jmod = sp.load_reference("examples/quickstart.py")
    jruns, truns = sp.patch_pair(monkeypatch, jmod, quickstart)
    want = _printed(capsys, jmod.main)
    got = sp.one_thread(_printed, capsys, quickstart.main, ["--device", "cpu"])
    sp.assert_same_runs(jruns, truns)
    assert got == want
    assert [r.framework for r in jruns] == ["hermes", "bsp"]
    assert "Hermes speedup vs BSP: " in got and sp.pushes(jruns) > 0


def test_train_hermes_cluster_matches_reference(monkeypatch, capsys,
                                                tmp_path):
    jmod = sp.load_reference("examples/train_hermes_cluster.py")
    jruns, truns = sp.patch_pair(monkeypatch, jmod, train_hermes_cluster)
    want_path, got_path = tmp_path / "ref.json", tmp_path / "t" / "port.json"
    monkeypatch.setattr("sys.argv", ["x", "--fast", "--out", str(want_path)])
    want = _printed(capsys, jmod.main)
    got = sp.one_thread(_printed, capsys, train_hermes_cluster.main,
                        ["--fast", "--out", str(got_path), "--device", "cpu"])
    sp.assert_same_runs(jruns, truns)
    assert got.replace(str(got_path), "OUT") == \
        want.replace(str(want_path), "OUT")
    report = json.loads(got_path.read_text())
    assert report == json.loads(want_path.read_text())
    assert list(report) == ["bsp", "asp", "ssp", "ebsp", "selsync", "hermes"]
    assert report["hermes"]["pushes"] > 0


def test_multi_pod_hermes_matches_reference(monkeypatch, capsys):
    """Both trainers cut to 16 steps (lam 8: three Hermes rounds, one
    merge), the port from the reference's initial model and int4 noise.
    The merges are equal.  The losses, rounded to 4 decimals by the
    example, are held at rtol 2e-4: the two packages' fp32 LM losses
    agree to ~1e-5 after 16 AdamW steps, so their roundings may land a
    unit apart.  The global loss after the int4 merge, and the best pod
    loss (a pod refreshed from that merge), at rtol 1e-3: a
    ~1e-6 gap of a pod's delta can move an element across a stochastic
    rounding boundary, one int4 level (absmax/7 of its block) apart."""
    jmod = sp.load_reference("examples/multi_pod_hermes.py")
    params0 = jax.device_get(jinit_lm(jtrain._preset("lmtiny"),
                                      jax.random.PRNGKey(0))[0])

    def cut(fn, **extra):
        def run(cfg, **kw):
            return fn(cfg, **dict(kw, steps=min(kw["steps"], 16), **extra))
        return run

    monkeypatch.setattr(jmod, "train_single", cut(jtrain.train_single))
    monkeypatch.setattr(jmod, "train_hermes", cut(jtrain.train_hermes))
    monkeypatch.setattr(multi_pod_hermes, "train_single",
                        cut(multi_pod_hermes.train_single, params0=params0))
    monkeypatch.setattr(multi_pod_hermes, "train_hermes",
                        cut(multi_pod_hermes.train_hermes, params0=params0,
                            noise=jax_noise(0)))
    want = _printed(capsys, jmod.main)
    got = sp.one_thread(_printed, capsys, multi_pod_hermes.main,
                        ["--device", "cpu"])

    def summary(text):
        return json.loads(text[text.rindex("{\n"):])

    w, g = summary(want), summary(got)
    assert list(g) == list(w)
    assert g["merge_rounds"] == w["merge_rounds"] == "1/3"
    assert g["comm_fraction"] == w["comm_fraction"]
    for k, rtol in (("baseline_final_loss", 2e-4),
                    ("hermes_best_pod_loss", 1e-3),
                    ("hermes_global_loss", 1e-3)):
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)
    heads = [re.sub(r"\n.*", "", t) for t in (want, got)]
    assert heads[0] == heads[1] == \
        "== dense baseline (every-step sync semantics) =="


def test_serve_decode_examples_run(capsys):
    """Both packages' ``serve_decode.py`` on the CPU: the three smoke
    configs served in the same order (timings differ)."""
    sp.load_reference("examples/serve_decode.py").main()
    want = capsys.readouterr().out.splitlines()
    serve_decode.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in got] == \
        [line.split()[0] for line in want] == \
        ["qwen3-8b", "rwkv6-3b", "recurrentgemma-2b"]
    assert all("tok/s" in line for line in got)
