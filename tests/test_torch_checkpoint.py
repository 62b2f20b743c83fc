"""The port's checkpointer against ``repro.checkpoint`` on the CPU: the
same manifest key for key, dtypes kept (bf16 as its raw bits), retention
and the atomic rename, and checkpoints that cross between the packages
bit for bit."""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.checkpoint import checkpointer as jck
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.launch.train import _preset as jpreset
from repro.models import init_lm as jinit_lm
from repro.optim import make_optimizer as jmake_optimizer

from repro_torch import bridge
from repro_torch.checkpoint import (
    Checkpointer, latest_step, restore_tree, save_tree,
)
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.config import OptimizerConfig
from repro_torch.optim.optimizers import make_optimizer


def _states(step: int = 5):
    """The lmtiny single-trainer state of both packages, from one set of
    parameters, with AdamW moments that are not zero and ``step`` set."""
    params = jax.device_get(jinit_lm(jpreset("lmtiny"),
                                     jax.random.PRNGKey(0))[0])
    rng = np.random.default_rng(1)
    m = jax.tree.map(lambda x: rng.standard_normal(x.shape)
                     .astype(np.float32), params)
    v = jax.tree.map(lambda x: rng.random(x.shape).astype(np.float32),
                     params)
    jopt = jmake_optimizer(JOptimizerConfig(name="adamw")).init(params)
    assert sorted(jopt) == ["m", "step", "v"]
    jstate = {"params": params,
              "opt": {"step": jnp.int32(step), "m": m, "v": v},
              "step": jnp.int32(step)}
    topt = make_optimizer(OptimizerConfig(name="adamw")).init(
        bridge.from_numpy(params, "cpu"))
    assert sorted(topt) == ["m", "step", "v"] and topt["step"] == 0
    tstate = {"params": bridge.from_numpy(params, "cpu"),
              "opt": {"step": step, "m": bridge.from_numpy(m, "cpu"),
                      "v": bridge.from_numpy(v, "cpu")},
              "step": step}
    return jstate, tstate


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes (bf16 included) for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_manifest_matches_reference_key_for_key(tmp_path):
    jstate, tstate = _states()
    want = [k for k, _ in jck._flatten_with_paths(jstate)]
    got = [k for k, _ in tck._flatten_with_paths(tstate)]
    assert got == want
    assert "opt/step" in got and "step" in got and len(got) > 20
    jpath = jck.save_tree(jstate, str(tmp_path / "ref"), 5)
    tpath = save_tree(tstate, str(tmp_path / "port"), 5)
    assert _manifest(tpath) == _manifest(jpath)
    with np.load(os.path.join(jpath, "arrays.npz")) as a, \
            np.load(os.path.join(tpath, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype
            np.testing.assert_array_equal(a[name], b[name])


def test_round_trip_keeps_fp32_int32_bf16_and_ints(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"params": {"w": torch.randn(8, 4, generator=gen),
                       "b": torch.randn(4, generator=gen)
                       .to(torch.bfloat16)},
            "opt": [torch.randn(8, 4, generator=gen),
                    torch.tensor(7, dtype=torch.int32)],
            "step": 42}
    path = save_tree(tree, str(tmp_path), 3, extra={"note": "x"})
    m = _manifest(path)
    assert m["extra"] == {"note": "x"} and m["step"] == 3
    assert {l["key"]: l["dtype"] for l in m["leaves"]} == {
        "opt/0": "float32", "opt/1": "int32", "params/b": "bfloat16",
        "params/w": "float32", "step": "int32"}
    template = {"params": {"w": torch.zeros(8, 4),
                           "b": torch.zeros(4, dtype=torch.bfloat16)},
                "opt": [torch.zeros(8, 4), torch.tensor(0, dtype=torch.int32)],
                "step": 0}
    back, step = restore_tree(template, str(tmp_path), device="cpu")
    assert step == 3 and back["step"] == 42 and isinstance(back["step"], int)
    for k, x in (("w", tree["params"]["w"]), ("b", tree["params"]["b"])):
        assert back["params"][k].dtype == x.dtype
        assert torch.equal(back["params"][k], x)
    assert torch.equal(back["opt"][0], tree["opt"][0])
    assert back["opt"][1].dtype == torch.int32 and int(back["opt"][1]) == 7


def test_retention_atomic_rename_and_async(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_write=False)
    tree = {"w": torch.arange(6, dtype=torch.float32), "step": 0}
    for s in range(1, 6):
        ck.save({"w": tree["w"] + s, "step": s}, s)
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]
    # a crash mid-write leaves only the temporary directory: it is never
    # taken for a checkpoint
    os.makedirs(tmp_path / ".tmp_step_9")
    assert latest_step(str(tmp_path)) == 5
    back, step = ck.restore(tree)
    assert step == 5 and back["step"] == 5
    assert torch.equal(back["w"], tree["w"] + 5)
    # a rewrite of an existing step replaces it whole
    save_tree({"w": tree["w"] * 0, "step": 1}, str(tmp_path), 5)
    assert not (tmp_path / ".tmp_step_5").exists()
    assert torch.equal(restore_tree(tree, str(tmp_path))[0]["w"],
                       tree["w"] * 0)
    # async: the host copy is taken at save time, so an update after save
    # does not reach the file
    ck = Checkpointer(str(tmp_path / "a"), async_write=True)
    live = torch.ones(1000)
    ck.save({"w": live, "step": 0}, 10)
    live.add_(1.0)
    back, step = ck.restore({"w": torch.zeros(1000), "step": 0})
    assert step == 10 and torch.equal(back["w"], torch.ones(1000))
    with pytest.raises(FileNotFoundError):
        restore_tree(tree, str(tmp_path / "empty"))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_lmtiny_checkpoint_crosses_the_packages(tmp_path, writer):
    jstate, tstate = _states(step=7)
    if writer == "reference":
        jck.save_tree(jstate, str(tmp_path), 7)
        _, template = _states(step=0)
        back, step = restore_tree(template, str(tmp_path), device="cpu")
        want = jstate
    else:
        save_tree(tstate, str(tmp_path), 7)
        template, _ = _states(step=0)
        back, step = jck.restore_tree(template, str(tmp_path))
        want = tstate
    assert step == 7
    got_flat = tck._flatten_with_paths(back) if writer == "reference" \
        else jck._flatten_with_paths(back)
    want_flat = jck._flatten_with_paths(want) if writer == "reference" \
        else tck._flatten_with_paths(want)
    assert [k for k, _ in got_flat] == [k for k, _ in want_flat]
    for (key, g), (_, w) in zip(got_flat, want_flat):
        if key.endswith("step"):
            assert int(g) == int(w) == 7, key
            continue
        gb, wb = _bits(g), _bits(w)
        assert gb.dtype == wb.dtype and gb.shape == wb.shape, key
        np.testing.assert_array_equal(gb, wb, err_msg=key)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bf16_leaves_cross_the_packages(tmp_path, writer):
    vals = np.random.default_rng(3).standard_normal((5, 7)) \
        .astype(ml_dtypes.bfloat16)
    jtree = {"a": {"w": jnp.asarray(vals)}, "n": jnp.int32(2)}
    ttree = {"a": {"w": bridge.from_numpy({"w": vals}, "cpu")["w"]}, "n": 2}
    assert ttree["a"]["w"].dtype == torch.bfloat16
    if writer == "reference":
        jck.save_tree(jtree, str(tmp_path), 1)
        back, _ = restore_tree(
            {"a": {"w": torch.zeros(5, 7, dtype=torch.bfloat16)}, "n": 0},
            str(tmp_path))
        got = back["a"]["w"]
        assert back["n"] == 2
    else:
        save_tree(ttree, str(tmp_path), 1)
        back, _ = jck.restore_tree(jtree, str(tmp_path))
        got = back["a"]["w"]
        assert int(back["n"]) == 2
    np.testing.assert_array_equal(_bits(got), vals.view(np.uint16))
