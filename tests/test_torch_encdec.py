"""The encoder-decoder (seamless-m4t-large-v2's ``seamless-smoke``: 2
encoder and 2 decoder layers, d 64) of the port against the JAX
reference on the CPU: the sinusoidal positions, the forward, the loss
and every parameter's gradient, prefill (encode, cross K / V, BOS) and
decode, decode against the port's own forward, ``serve`` token for
token, and ``launch/steps.py``'s setups.

Both sides start from the reference's parameters (through
``repro_torch.bridge``) and inputs drawn with numpy from a seed.  The
frames are N(0, 1) embeddings plus the sinusoidal positions, so the
encoder's residual stream reaches ~30, and the smoke init's attention
scores have a standard deviation of ~16 (``wq (64, 4, 16)`` is scaled by
4^-1/2), so a softmax turns an fp32 rounding of a score into a visible
change of its weights: the port's fp32 forward is itself 3.5e-4 (naive)
to 8e-4 (the flash kernels' plain version) from an fp64 run of the same
model, of logits up to ~4.3.  The fp32 tolerances below are
:data:`REL` of the largest value compared, about twice that.
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
from repro.models import layers as JL
from repro.models import lm_forward as jlm_forward
from repro.models import lm_loss as jlm_loss
from repro.models import prefill_step as jprefill_step

from repro_torch import bridge
from repro_torch.config import OptimizerConfig, ParallelConfig, ShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import steps
from repro_torch.launch.serve import prompt_frames, serve
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.utils.trees import tree_flatten

import torch_parity  # noqa: F401  (caps torch's threads)

ARCH = "seamless-m4t-large-v2"
CPU = torch.device("cpu")
REL = 5e-4


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jsmoke(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jparams(seed):
    jcfg, _ = _cfgs()
    return jax.device_get(jax.jit(
        lambda key: jinit_lm(jcfg, key)[0])(jax.random.PRNGKey(seed)))


def _batch(seed, B=2, S_enc=10, T=12):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, S_enc, 64)).astype(np.float32)
    tokens = rng.integers(0, 256, (B, T))
    targets = rng.integers(0, 256, (B, T))
    targets[0, -2:] = -1        # masked targets, as the reference allows
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens),
          "targets": jnp.asarray(targets)}
    tb = {"frames": torch.from_numpy(frames),
          "tokens": torch.from_numpy(tokens),
          "targets": torch.from_numpy(targets)}
    return jb, tb


def _close(got, want, rel, msg=""):
    """Within ``rel`` of the largest magnitude compared."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1.0), err_msg=msg)


def test_sinusoidal_positions_match_reference():
    """The numpy table bit for bit; the torch fp32 ``sinusoidal_at``
    within an fp32 rounding of sin / cos (values in [-1, 1])."""
    for S, d in ((10, 64), (1024, 1024), (7, 6)):
        np.testing.assert_array_equal(
            L.sinusoidal_positions(S, d),
            np.asarray(JL.sinusoidal_positions(S, d)))
    pos = np.arange(0, 2000, 7)
    got = L.sinusoidal_at(torch.from_numpy(pos), 1024).numpy()
    want = np.asarray(JL.sinusoidal_at(jnp.asarray(pos), 1024))
    # the angle pos * div is one fp32 product on both sides; sin and cos
    # of angles up to 2000 rad in two libraries: a few ulps of the angle
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    # decode's embedding at a position against the forward's table row
    np.testing.assert_allclose(got, L.sinusoidal_positions(2000, 1024)[pos],
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_forward_matches_reference(impl):
    """Decoder logits of one batch; ``kernel`` on the CPU is the flash
    kernels' plain version (non-causal encoder and cross attention)."""
    jcfg, tcfg = _cfgs()
    jp = _jparams(0)
    jb, tb = _batch(1)
    want = np.asarray(jlm_forward(jp, jb, jcfg, impl="naive"))
    with torch.no_grad():
        got = lm.lm_forward(bridge.from_numpy(jp, CPU), tb, tcfg,
                            impl=impl).numpy()
    assert got.shape == want.shape == (2, 12, 256)
    # fp32 through 4 blocks in other summation orders (module docstring)
    _close(got, want, REL)


def test_loss_and_grads_match_reference():
    """The masked mean cross-entropy and every parameter's gradient (the
    encoder's, the cross-attentions', the embedding's) against
    ``jax.grad``."""
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
    # a mean of fp32 log-sum-exps ~5.5: ~10 ulps
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    jleaves = jax.tree.leaves(jax.device_get(jgrads))
    assert len(jleaves) == len(tgrads)
    assert {k for k in tp} == {"embedding", "encoder", "decoder",
                               "final_norm"}
    for i, (got, want) in enumerate(zip(tgrads, jleaves)):
        assert tuple(got.shape) == want.shape
        # fp32 backward through 4 blocks (module docstring): REL of the
        # leaf's largest gradient (the encoder's leaves reach it through
        # cross-attention)
        _close(got.numpy(), want, REL, msg=f"leaf {i}")


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_prefill_and_decode_match_reference(impl):
    """``prefill_step`` (encode 10 frames, write each decoder layer's cross
    K / V, decode BOS at 0), then 5 ``decode_step``s from position 1 fed
    the reference's tokens: every step's logits and the caches."""
    jcfg, tcfg = _cfgs()
    jp = _jparams(4)
    jb, tb = _batch(5)
    B, S_enc, steps_ = 2, 10, 5
    jcache = jinit_cache(jcfg, B, 8, enc_len=S_enc, dtype=jnp.float32)
    jlogits, jcache = jax.jit(lambda p, c, b: jprefill_step(p, c, b, jcfg))(
        jp, jcache, {"frames": jb["frames"]})
    tp = bridge.from_numpy(jp, CPU)
    tcache = lm.init_cache(tcfg, B, 8, enc_len=S_enc, dtype=torch.float32,
                           device="cpu")
    with torch.no_grad():
        tlogits, tcache = lm.prefill_step(tp, tcache,
                                          {"frames": tb["frames"]}, tcfg,
                                          impl=impl)
    assert set(tcache) == {"self", "cross"} and \
        tuple(tcache["cross"]["k"].shape) == (2, B, S_enc, 4, 16)
    # fp32 through 2 encoder and 2 decoder blocks (module docstring)
    _close(tlogits.numpy(), jlogits, REL)
    jdec = jax.jit(lambda p, c, t, pos: jdecode_step(p, c, t, pos, jcfg))
    tok = np.array(jnp.argmax(jlogits[:, -1:], axis=-1))
    for i in range(steps_):
        jlogits, jcache = jdec(jp, jcache, jnp.asarray(tok, jnp.int32),
                               jnp.int32(1 + i))
        with torch.no_grad():
            tlogits, tcache = lm.decode_step(tp, tcache,
                                             torch.from_numpy(tok), 1 + i,
                                             tcfg, impl=impl)
        _close(tlogits.numpy(), jlogits, REL, msg=f"decode step {i}")
        tok = np.array(jnp.argmax(jlogits[:, -1:], axis=-1))
    got, want = tree_flatten(bridge.to_numpy(tcache))[0], \
        jax.tree.leaves(jax.device_get(jcache))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        # the cross K / V and the written self slots; unwritten slots 0
        # and their positions -1 on both sides
        _close(a, b, REL)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_decode_matches_forward(impl):
    """BOS then the tokens, one at a time from the prefill, give the
    forward's logits at every position (the reference's
    ``test_decode_matches_forward`` rule, BOS first), fp32 cache."""
    _, tcfg = _cfgs()
    tp = bridge.from_numpy(_jparams(6), CPU)
    _, tb = _batch(7, T=8)
    T = 8
    toks = torch.cat([torch.zeros((2, 1), dtype=torch.int64),
                      tb["tokens"][:, :T - 1]], dim=1)
    with torch.no_grad():
        full = lm.lm_forward(tp, {"frames": tb["frames"], "tokens": toks},
                             tcfg, impl="naive")
        cache = lm.init_cache(tcfg, 2, T, enc_len=10, dtype=torch.float32,
                              device="cpu")
        lg, cache = lm.prefill_step(tp, cache, {"frames": tb["frames"]},
                                    tcfg, impl=impl)
        steps_ = [lg]
        for t in range(1, T):
            lg, cache = lm.decode_step(tp, cache, toks[:, t:t + 1], t, tcfg,
                                       impl=impl)
            steps_.append(lg)
    # fp32, the same operations grouped per step; the forward's positions
    # come from the numpy table, decode's from sinusoidal_at (~1e-7 apart
    # at these positions); module docstring
    _close(torch.cat(steps_, dim=1).numpy(), full.numpy(), REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_matches_reference(dtype):
    """``serve`` at seamless-smoke (batch 2, 10 frames, 6 new tokens) token
    for token against ``repro.launch.serve.serve`` from the reference's
    init of the same seed (bf16: the smoke config's own compute dtype)."""
    jcfg, tcfg = _cfgs(dtype)
    want = jserve(jcfg, batch=2, prompt_len=10, gen=6, seed=0)
    params = bridge.from_numpy(jax.device_get(
        jinit_lm(jcfg, jax.random.PRNGKey(0))[0]), CPU)
    got = serve(tcfg, batch=2, prompt_len=10, gen=6, seed=0, device="cpu",
                params=params, keep_logits=True)
    assert got["generated"] == want["generated"]
    assert got["tokens"].shape == (2, 7)
    assert prompt_frames(tcfg, 2, 10, 0).shape == (2, 10, 64)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_paths(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _shape_dtype(leaf):
    if isinstance(leaf, steps.Spec):
        return leaf.shape, str(leaf.dtype).removeprefix("torch.")
    return tuple(leaf.shape), str(np.dtype(leaf.dtype))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_step_specs_match_reference_at_full_width(kind):
    """seamless-m4t-large-v2's setups, shapes only: the parameters
    (1,632,253,952), the ``{"self", "cross"}`` cache (``enc_len`` S to
    prefill, ``min(4096, S)`` to decode) and the batch with ``frames (B,
    S, d)`` (tokens are int64 in the port, int32 in the reference)."""
    rules = make_rules(jax.make_mesh((1, 1), ("data", "model")))
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    S = 4608 if kind == "decode" else 1024
    jshape, tshape = JShapeConfig("s", S, 4, kind), ShapeConfig("s", S, 4,
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
        assert all(_shape_dtype(g[k]) == _shape_dtype(w[k]) for k in w)
        enc = min(4096, S) if kind == "decode" else S
        assert g["/cross/k"].shape == (24, 4, enc, 16, 64)
    w, g = _paths(wparams), _paths(gparams)
    assert list(g) == list(w)
    assert all(_shape_dtype(g[k])[0] == _shape_dtype(w[k])[0] for k in w)
    assert sum(int(np.prod(x.shape)) for x in g.values()) == \
        tcfg.param_count() == 1_632_253_952
    if kind == "decode":
        assert got[2].shape == tuple(want[2].shape) == (4, 1)
        return
    wb, gb = want[-1], got[-1]
    assert set(gb) == set(wb) == ({"frames", "tokens", "targets"}
                                  if kind == "train" else
                                  {"frames", "tokens"})
    for k in wb:
        assert gb[k].shape == tuple(wb[k].shape), k
    assert gb["frames"].shape == (4, S, 1024) and \
        gb["frames"].dtype == torch.bfloat16
    assert str(wb["frames"].dtype) == "bfloat16"


def test_train_setup_steps_match_reference():
    """Two SGD steps of each package's train setup at seamless-smoke (fp32,
    naive attention) on one batch with frames.  The random init is
    chaotic under SGD (gradients up to ~30): the reference's own third
    loss moves by ~0.03 at lr 1e-3 (~0.13 at lr 0.1) when its initial
    parameters move by 1e-6 of themselves, so two steps at lr 1e-3 are
    compared."""
    jcfg, tcfg = _cfgs()
    rules = make_rules(jax.make_mesh((1, 1), ("data", "model")))
    opt = dict(name="sgd", lr=1e-3)
    jset = jsteps.make_train_setup(
        jcfg, JShapeConfig("t", 12, 2, "train"), rules, JParallelConfig(),
        JOptimizerConfig(**opt), impl="naive")
    tset = steps.make_train_setup(
        tcfg, ShapeConfig("t", 12, 2, "train"), ParallelConfig(),
        OptimizerConfig(**opt), impl="naive", device="cpu")
    jp = _jparams(8)
    jstate = {"params": jax.tree.map(jnp.asarray, jp),
              "opt": jset.meta["optimizer"].init(jp), "step": jnp.int32(0)}
    tp = bridge.from_numpy(jp, CPU)
    tstate = {"params": tp, "opt": tset.meta["optimizer"].init(tp),
              "step": 0}
    jb, tb = _batch(9, S_enc=12, T=12)
    jstep = jax.jit(jset.step_fn)
    for _ in range(2):
        jstate, jloss = jstep(jstate, jb)
        tstate, tloss = tset.step_fn(tstate, tb)
        # fp32 losses ~5.8, the second after one step from parameters
        # that differ by lr x the gradients' gap
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-5)
    assert tstate["step"] == int(jstate["step"]) == 2
    want = _paths(jax.device_get(jstate["params"]))
    got = _paths(bridge.to_numpy(tstate["params"]))
    for k in want:
        # each step moves a weight by lr x its gradient; the gradients
        # agree to REL of their scale (up to ~30)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
