"""The step builders (``repro_torch.launch.steps``) and the optimizers'
momentum and master weights against the JAX reference on the CPU, and
the trainer's CLI at deepseek-v2-lite's smoke config (``serve_decode``
of both packages is in ``test_torch_examples.py``)."""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import ParallelConfig as JParallelConfig
from repro.config import ShapeConfig as JShapeConfig
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jsmoke
from repro.dist.sharding import make_rules
from repro.launch import steps as jsteps
from repro.models import init_lm as jinit_lm
from repro.optim import make_optimizer as jmake_optimizer

from repro_torch import bridge
from repro_torch.config import OptimizerConfig, ParallelConfig, ShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.optim.optimizers import make_optimizer

from torch_parity import CHILD_ENV

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _jparams(arch, seed):
    """The reference's fp32 smoke init (jitted: its eager init takes
    seconds), as numpy."""
    jcfg = dataclasses.replace(jsmoke(arch), dtype="float32")
    return jax.device_get(jax.jit(
        lambda key: jinit_lm(jcfg, key)[0])(jax.random.PRNGKey(seed)))


def _rules():
    return make_rules(jax.make_mesh((1, 1), ("data", "model")))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_paths(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _spec_of(leaf):
    if isinstance(leaf, steps.Spec):
        return leaf.shape, str(leaf.dtype).removeprefix("torch.")
    return tuple(leaf.shape), str(np.dtype(leaf.dtype))


def _same_specs(got, want):
    got, want = _paths(got), _paths(want)
    assert list(got) == list(want)
    for k in want:
        assert _spec_of(got[k]) == _spec_of(want[k]), k


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_state_specs_match_reference(arch, dtype):
    """bf16: bf16 parameters, fp32 ``master`` / ``m`` / ``v``."""
    jcfg = dataclasses.replace(jsmoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    shape = (32, 4)
    want = jsteps.make_train_setup(
        jcfg, JShapeConfig("t", *shape, "train"), _rules(),
        JParallelConfig(), JOptimizerConfig(name="adamw")).abstract_args
    got = steps.make_train_setup(
        tcfg, ShapeConfig("t", *shape, "train"), ParallelConfig(),
        OptimizerConfig(name="adamw"), device="cpu").arg_specs
    _same_specs(got[0], want[0])
    assert set(got[0]["opt"]) == ({"step", "m", "v", "master"}
                                  if dtype == "bfloat16"
                                  else {"step", "m", "v"})
    assert {k: v.shape for k, v in got[1].items()} == \
        {k: v.shape for k, v in want[1].items()}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serve_specs_match_reference_at_full_width(kind):
    """deepseek-v2-lite-16b's bf16 parameters and its stacked latent cache,
    shapes only (``eval_shape`` and the ``meta`` device)."""
    arch = "deepseek-v2-lite-16b"
    jshape, tshape = JShapeConfig("s", 1057, 4, kind), \
        ShapeConfig("s", 1057, 4, kind)
    jmake = getattr(jsteps, f"make_{kind}_setup")
    tmake = getattr(steps, f"make_{kind}_setup")
    want = jmake(jget_config(arch), jshape, _rules()).abstract_args
    got = tmake(get_config(arch), tshape, device="cpu").arg_specs
    _same_specs(got[0], want[0])
    _same_specs(got[1], want[1])
    params = _paths(got[0])
    assert sum(int(np.prod(s.shape)) for s in params.values()) == \
        16_210_324_992
    assert {s.dtype for s in params.values()} == {torch.bfloat16}
    assert got[1]["c_kv"].shape == (27, 4, 1057, 512)


def _train_pair(arch, opt, mb=0, seed=0):
    jcfg = dataclasses.replace(jsmoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jset = jsteps.make_train_setup(
        jcfg, JShapeConfig("t", 16, 4, "train"), _rules(), JParallelConfig(),
        JOptimizerConfig(**opt), impl="naive")
    tset = steps.make_train_setup(
        tcfg, ShapeConfig("t", 16, 4, "train"), ParallelConfig(microbatch=mb),
        OptimizerConfig(**opt), impl="naive", device="cpu")
    jparams = _jparams(arch, seed)
    jstate = {"params": jax.tree.map(jnp.asarray, jparams),
              "opt": jset.meta["optimizer"].init(jparams),
              "step": jnp.int32(0)}
    params = bridge.from_numpy(jparams, CPU)
    tstate = {"params": params, "opt": tset.meta["optimizer"].init(params),
              "step": 0}
    rng = np.random.default_rng(seed + 1)
    batch = {k: rng.integers(0, tcfg.vocab_size, (4, 16))
             for k in ("tokens", "targets")}
    return jset, tset, jstate, tstate, batch


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b"])
def test_train_steps_match_reference(arch):
    """Two steps of each package's ``step_fn`` (naive attention, the
    sorted MoE dispatch, SGD) from one init and batch, in fp32."""
    jset, tset, jstate, tstate, batch = _train_pair(
        arch, dict(name="sgd", lr=0.1))
    jstep = jax.jit(jset.step_fn)
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(2):
        jstate, jloss = jstep(jstate, jb)
        tstate, tloss = tset.step_fn(tstate, tb)
        # fp32 losses ~5.5 from sums in other orders: ~10 ulps
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    assert tstate["step"] == int(jstate["step"]) == 2
    want = _paths(jax.device_get(jstate["params"]))
    got = _paths(bridge.to_numpy(tstate["params"]))
    for k in want:
        # SGD at lr 0.1 moves a weight by lr * grad; the grads agree to
        # ~1e-6 of their scale, so the parameters (~0.1-1) to ~1e-6
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-6,
                                   err_msg=k)


def test_microbatch_matches_whole_batch():
    """``microbatch=2`` (two backwards, the gradient summed) is the same
    step as the whole batch, at the dense qwen3-smoke (the MoE's sorted
    dispatch sizes its capacity by the microbatch, so it differs there, as
    in the reference)."""
    _, whole, _, st0, batch = _train_pair("qwen3-8b", dict(name="sgd",
                                                           lr=0.1))
    _, split, _, st1, _ = _train_pair("qwen3-8b", dict(name="sgd", lr=0.1),
                                      mb=2)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(2):
        st0, l0 = whole.step_fn(st0, tb)
        st1, l1 = split.step_fn(st1, tb)
        # the mean of two half-batch means: fp32, a few ulps of ~5.5
        np.testing.assert_allclose(float(l1), float(l0), rtol=2e-6)
    for a, b in zip(_paths(st0["params"]).values(),
                    _paths(st1["params"]).values()):
        # SGD moves a weight by lr * grad; the two gradients are one sum
        # in two orders, ~1e-7 apart, so the weights ~1e-8
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6)


@pytest.mark.parametrize("master", [False, True])
def test_sgdm_matches_reference(master):
    """Three momentum steps on bf16 parameters (fp32 ``mom``; with master
    weights, fp32 ``master`` updated and the parameters its cast)."""
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((8, 16)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape)
                          .astype(np.float32), params) for _ in range(3)]
    kw = dict(name="sgdm", lr=0.05, momentum=0.9)
    jopt = jmake_optimizer(JOptimizerConfig(**kw), master_weights=master)
    topt = make_optimizer(OptimizerConfig(**kw), master_weights=master)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    tp = bridge.from_numpy(jax.device_get(jp), CPU)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jg = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), g)
        tg = bridge.from_numpy(jax.device_get(jg), CPU)
        jp, js = jopt.apply(jp, jg, js)
        tp, ts = topt.apply(tp, tg, ts)
    assert set(ts) == set(js) and ts["step"] == int(js["step"]) == 3
    for k, want in _paths(jax.device_get(js["mom"])).items():
        got = _paths(bridge.to_numpy(ts["mom"]))[k]
        # fp32 momentum of bf16 gradients: the same fp32 operations
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for k, want in _paths(jax.device_get(jp)).items():
        got = _paths(bridge.to_numpy(tp))[k]
        assert _paths(tp)[k].dtype == torch.bfloat16
        # the same operations in the same dtypes (with master weights the
        # cast of the same fp32 master): bitwise
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b"])
def test_prefill_and_decode_setups_match_reference(arch):
    """The setups' ``step_fn`` against the reference's ``prefill_step`` and
    ``decode_step`` (what its setups call, here without a mesh) from one
    init and prompt: prefill, then three decode steps, logits and the
    cache, in fp32 (an fp32 cache in place of the setups' bf16 one, so a
    bf16 rounding flip does not hide a fault), naive attention, the
    sorted MoE."""
    jcfg = dataclasses.replace(jsmoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    B, S, T = 2, 16, 9
    ts = {k: getattr(steps, f"make_{k}_setup")(
        tcfg, ShapeConfig("s", S, B, k), impl="naive", device="cpu")
        for k in ("prefill", "decode")}
    _, tcache = ts["prefill"].init_state(0)
    assert tcache["pos"].shape == (tcfg.num_layers, S)
    assert {t.dtype for k, t in tcache.items() if k != "pos"} == \
        {torch.bfloat16}
    jparams = _jparams(arch, 0)
    tparams = bridge.from_numpy(jparams, CPU)
    jcache = jsteps.LM.init_cache(jcfg, B, S, dtype=jnp.float32)
    tcache = lm.init_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    kw = dict(impl="naive", moe_impl="sorted")
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (B, T))
    jlog, jcache = jax.jit(lambda p, c, b: jsteps.LM.prefill_step(
        p, c, b, jcfg, None, **kw))(
        jparams, jcache, {"tokens": jnp.asarray(toks[:, :6], jnp.int32)})
    tlog, tcache = ts["prefill"].step_fn(
        tparams, tcache, {"tokens": torch.from_numpy(toks[:, :6])})
    jdecode = jax.jit(lambda p, c, t, pos: jsteps.LM.decode_step(
        p, c, t, pos, jcfg, None, **kw))
    for t in range(6, T + 1):
        # fp32 logits through 2 blocks in other orders: 1e-5 of the
        # largest logit (a few hundred ulps of it)
        atol = 1e-5 * float(np.abs(np.asarray(jlog)).max())
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=atol, err_msg=f"position {t}")
        if t == T:
            break
        jlog, jcache = jdecode(jparams, jcache,
                               jnp.asarray(toks[:, t:t + 1], jnp.int32),
                               jnp.int32(t))
        tlog, tcache = ts["decode"].step_fn(
            tparams, tcache, torch.from_numpy(toks[:, t:t + 1]), t)
    assert tcache["pos"][0].tolist() == list(range(T)) + [-1] * (S - T)
    for k, want in _paths(jax.device_get(jcache)).items():
        got = _paths(bridge.to_numpy(tcache))[k]
        # fp32 keys, values or latents, projections summed in other
        # orders: 1e-5 of the largest entry
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_train_cli_runs_deepseek_smoke():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **CHILD_ENV)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--preset",
         "deepseek-v2-lite-16b", "--hermes", "--device", "cpu", "--steps",
         "4", "--pods", "2"], capture_output=True, text=True, env=env,
        timeout=120, check=True)
    res = json.loads(out.stdout[out.stdout.index("{"):])
    losses = [res["global_loss"]] + res["pod_losses"]
    assert res["steps"] == 4 and len(res["pod_losses"]) == 2
    assert all(np.isfinite(x) for x in losses)
