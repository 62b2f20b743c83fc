"""The vision frontend (llava-next-34b's ``llava-smoke``: the dense stack,
2 layers, d 64, GQA 4 heads on 2) of the port against the JAX reference
on the CPU: ``frontend_embeds`` prepended to the token embeddings in the
forward and the prefill, the loss on the logits' tail and every
parameter's gradient, decode from position F + T, decode against the
port's own forward, ``serve`` token for token, and ``launch/steps.py``'s
setups with the reference's ``input_specs`` rule ``F = min(
frontend_tokens, S // 2) or S // 8``.

Both sides start from the reference's parameters (through
``repro_torch.bridge``) and inputs drawn with numpy from a seed; the
patch embeddings are N(0, 1).
"""
import dataclasses
import functools

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
from repro.launch.serve import serve as jserve
from repro.models import decode_step as jdecode_step
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import lm_forward as jlm_forward
from repro.models import lm_loss as jlm_loss
from repro.models import prefill_step as jprefill_step

from repro_torch import bridge
from repro_torch.config import OptimizerConfig, ParallelConfig, ShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import steps
from repro_torch.launch.serve import serve
from repro_torch.models import lm
from repro_torch.utils.trees import tree_flatten

import torch_parity  # noqa: F401  (caps torch's threads)

ARCH = "llava-next-34b"
CPU = torch.device("cpu")


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jsmoke(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jparams(seed):
    jcfg, _ = _cfgs()
    return jax.device_get(jax.jit(
        lambda key: jinit_lm(jcfg, key)[0])(jax.random.PRNGKey(seed)))


def _batch(seed, B=2, F=6, T=10):
    rng = np.random.default_rng(seed)
    fe = rng.normal(size=(B, F, 64)).astype(np.float32)
    tokens = rng.integers(0, 256, (B, T))
    targets = rng.integers(0, 256, (B, T))
    targets[1, :2] = -1         # masked targets, as the reference allows
    jb = {"frontend_embeds": jnp.asarray(fe), "tokens": jnp.asarray(tokens),
          "targets": jnp.asarray(targets)}
    tb = {"frontend_embeds": torch.from_numpy(fe),
          "tokens": torch.from_numpy(tokens),
          "targets": torch.from_numpy(targets)}
    return jb, tb


def _close(got, want, rel, msg=""):
    """Within ``rel`` of the largest magnitude compared."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1.0), err_msg=msg)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_forward_matches_reference(impl):
    """Logits over the 6 patch positions and the 10 tokens."""
    jcfg, tcfg = _cfgs()
    jp = _jparams(0)
    jb, tb = _batch(1)
    want = np.asarray(jlm_forward(jp, jb, jcfg, impl="naive"))
    with torch.no_grad():
        got = lm.lm_forward(bridge.from_numpy(jp, CPU), tb, tcfg,
                            impl=impl).numpy()
    assert got.shape == want.shape == (2, 16, 256)
    # fp32 through 2 blocks in other summation orders: 1e-5 of the
    # largest logit (as the dense zoo's test_smoke_logits_match_reference)
    _close(got, want, 1e-5)


def test_loss_and_grads_match_reference():
    """The masked cross-entropy of the logits' last 10 positions and every
    parameter's gradient against ``jax.grad``."""
    jcfg, tcfg = _cfgs()
    jp = _jparams(2)
    jb, tb = _batch(3)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm_loss(p, jb, jcfg, impl="naive"))(
            jax.tree.map(jnp.asarray, jp))
    tp = bridge.from_numpy(jp, CPU)
    leaves, _ = tree_flatten(tp)
    for x in leaves:
        x.requires_grad_(True)
    tloss = lm.lm_loss(tp, tb, tcfg, impl="naive")
    tgrads = torch.autograd.grad(tloss, leaves)
    # a mean of fp32 log-sum-exps ~5.5: a few ulps
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    # the tail alignment: the loss of the last 10 positions' logits
    with torch.no_grad():
        tail = lm.lm_forward(tp, tb, tcfg, impl="naive")[:, -10:]
        np.testing.assert_allclose(
            float(lm.cross_entropy(tail, tb["targets"])), float(tloss),
            rtol=1e-6)
    jleaves = jax.tree.leaves(jax.device_get(jgrads))
    assert len(jleaves) == len(tgrads)
    for i, (got, want) in enumerate(zip(tgrads, jleaves)):
        assert tuple(got.shape) == want.shape
        # fp32 backward through 2 blocks: 1e-4 of the leaf's largest
        _close(got.numpy(), want, 1e-4, msg=f"leaf {i}")


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_prefill_and_decode_match_reference(impl):
    """``prefill_step`` over 6 patch embeddings and 10 tokens, then 5
    ``decode_step``s from position 16 fed the reference's tokens: every
    step's logits and the caches."""
    jcfg, tcfg = _cfgs()
    jp = _jparams(4)
    jb, tb = _batch(5)
    B, P, n = 2, 16, 5
    pre = {k: jb[k] for k in ("frontend_embeds", "tokens")}
    jcache = jinit_cache(jcfg, B, P + n + 1, dtype=jnp.float32)
    jlogits, jcache = jax.jit(lambda p, c, b: jprefill_step(p, c, b, jcfg))(
        jp, jcache, pre)
    tp = bridge.from_numpy(jp, CPU)
    tcache = lm.init_cache(tcfg, B, P + n + 1, dtype=torch.float32,
                           device="cpu")
    with torch.no_grad():
        tlogits, tcache = lm.prefill_step(
            tp, tcache, {k: tb[k] for k in ("frontend_embeds", "tokens")},
            tcfg, impl=impl)
    assert tcache["pos"][0].tolist()[:P + 1] == list(range(P)) + [-1]
    # fp32 through 2 blocks: 1e-5 of the largest logit
    _close(tlogits.numpy(), jlogits, 1e-5)
    jdec = jax.jit(lambda p, c, t, pos: jdecode_step(p, c, t, pos, jcfg))
    tok = np.array(jnp.argmax(jlogits[:, -1:], axis=-1))
    for i in range(n):
        jlogits, jcache = jdec(jp, jcache, jnp.asarray(tok, jnp.int32),
                               jnp.int32(P + i))
        with torch.no_grad():
            tlogits, tcache = lm.decode_step(tp, tcache,
                                             torch.from_numpy(tok), P + i,
                                             tcfg, impl=impl)
        _close(tlogits.numpy(), jlogits, 1e-5, msg=f"decode step {i}")
        tok = np.array(jnp.argmax(jlogits[:, -1:], axis=-1))
    got, want = tree_flatten(bridge.to_numpy(tcache))[0], \
        jax.tree.leaves(jax.device_get(jcache))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_decode_matches_forward(impl):
    """The patches and 4 tokens prefilled, then the other 6 tokens one at a
    time from position 10, give the forward's logits at every position
    after the prefill (fp32 cache)."""
    _, tcfg = _cfgs()
    tp = bridge.from_numpy(_jparams(6), CPU)
    _, tb = _batch(7)
    F, T, n = 6, 10, 4
    with torch.no_grad():
        full = lm.lm_forward(tp, tb, tcfg, impl="naive")
        cache = lm.init_cache(tcfg, 2, F + T, dtype=torch.float32,
                              device="cpu")
        lg, cache = lm.prefill_step(
            tp, cache, {"frontend_embeds": tb["frontend_embeds"],
                        "tokens": tb["tokens"][:, :n]}, tcfg, impl=impl)
        steps_ = [lg]
        for t in range(n, T - 1):
            lg, cache = lm.decode_step(tp, cache, tb["tokens"][:, t:t + 1],
                                       F + t, tcfg, impl=impl)
            steps_.append(lg)
    # fp32, the same operations grouped per step: 1e-5 of the largest
    _close(torch.cat(steps_, dim=1).numpy(),
           full[:, F + n - 1:F + T - 1].numpy(), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_matches_reference(dtype):
    """``serve`` at llava-smoke (batch 2, a 12-token prompt, 6 new
    tokens) token for token against ``repro.launch.serve.serve``, which
    serves a vision model from tokens alone."""
    jcfg, tcfg = _cfgs(dtype)
    want = jserve(jcfg, batch=2, prompt_len=12, gen=6, seed=0)
    params = bridge.from_numpy(jax.device_get(
        jinit_lm(jcfg, jax.random.PRNGKey(0))[0]), CPU)
    got = serve(tcfg, batch=2, prompt_len=12, gen=6, seed=0, device="cpu",
                params=params)
    assert got["generated"] == want["generated"]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_paths(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("kind,S", [("train", 6144), ("prefill", 6144),
                                    ("prefill", 1024), ("decode", 6176)])
def test_step_specs_match_reference_at_full_width(kind, S):
    """llava-next-34b's setups, shapes only: 34,388,917,248 parameters,
    the KV cache, and the batch by the reference's ``input_specs``: at S
    6144, 2880 patch positions and 3264 tokens; at S 1024, S // 2 = 512
    of each (tokens are int64 in the port, int32 in the reference)."""
    rules = make_rules(jax.make_mesh((1, 1), ("data", "model")))
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    jshape, tshape = JShapeConfig("s", S, 2, kind), ShapeConfig("s", S, 2,
                                                                kind)
    if kind == "train":
        want = jsteps.make_train_setup(
            jcfg, jshape, rules, JParallelConfig(),
            JOptimizerConfig(name="adamw")).abstract_args
        got = steps.make_train_setup(tcfg, tshape, ParallelConfig(),
                                     OptimizerConfig(name="adamw"),
                                     device="cpu").arg_specs
        wparams, gparams = want[0]["params"], got[0]["params"]
    else:
        make = f"make_{kind}_setup"
        want = getattr(jsteps, make)(jcfg, jshape, rules).abstract_args
        got = getattr(steps, make)(tcfg, tshape, device="cpu").arg_specs
        wparams, gparams = want[0], got[0]
        w, g = _paths(want[1]), _paths(got[1])
        assert list(g) == list(w)
        assert all(g[k].shape == tuple(w[k].shape) for k in w)
        assert g["/k"].shape == (60, 2, S, 8, 128)
    w, g = _paths(wparams), _paths(gparams)
    assert list(g) == list(w)
    assert all(g[k].shape == tuple(w[k].shape) for k in w)
    assert sum(int(np.prod(x.shape)) for x in g.values()) == \
        tcfg.param_count() == 34_388_917_248
    if kind == "decode":
        assert got[2].shape == tuple(want[2].shape) == (2, 1)
        return
    wb, gb = want[-1], got[-1]
    assert set(gb) == set(wb)
    for k in wb:
        assert gb[k].shape == tuple(wb[k].shape), k
    F = 2880 if S == 6144 else 512
    assert gb["frontend_embeds"].shape == (2, F, 7168) and \
        gb["frontend_embeds"].dtype == torch.bfloat16
    assert gb["tokens"].shape == (2, S - F)


def test_train_setup_steps_match_reference():
    """Two SGD steps of each package's train setup at llava-smoke (fp32,
    naive attention) on one batch of S 32: by the ``input_specs`` rule
    16 patch embeddings and 16 tokens."""
    jcfg, tcfg = _cfgs()
    rules = make_rules(jax.make_mesh((1, 1), ("data", "model")))
    opt = dict(name="sgd", lr=0.1)
    jset = jsteps.make_train_setup(
        jcfg, JShapeConfig("t", 32, 2, "train"), rules, JParallelConfig(),
        JOptimizerConfig(**opt), impl="naive")
    tset = steps.make_train_setup(
        tcfg, ShapeConfig("t", 32, 2, "train"), ParallelConfig(),
        OptimizerConfig(**opt), impl="naive", device="cpu")
    assert tset.arg_specs[1]["frontend_embeds"].shape == (2, 16, 64)
    jp = _jparams(8)
    jstate = {"params": jax.tree.map(jnp.asarray, jp),
              "opt": jset.meta["optimizer"].init(jp), "step": jnp.int32(0)}
    tp = bridge.from_numpy(jp, CPU)
    tstate = {"params": tp, "opt": tset.meta["optimizer"].init(tp),
              "step": 0}
    jb, tb = _batch(9, F=16, T=16)
    jstep = jax.jit(jset.step_fn)
    for _ in range(2):
        jstate, jloss = jstep(jstate, jb)
        tstate, tloss = tset.step_fn(tstate, tb)
        # fp32 losses ~5.5 from sums in other orders: ~10 ulps
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    want = _paths(jax.device_get(jstate["params"]))
    got = _paths(bridge.to_numpy(tstate["params"]))
    for k in want:
        # SGD at lr 0.1 moves a weight by lr * grad, twice; the grads
        # agree within 1e-4 of their scale (test_loss_and_grads_match_
        # reference), and the norms' scales' reach ~1: 2 x 0.1 x 1e-4
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=3e-5,
                                   err_msg=k)
