"""The port's LM loss, gradients and AdamW step against the JAX reference,
on the CPU, from one set of parameters (``jax.random`` init, handed over
through numpy by ``repro_torch.bridge``)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.config import ModelConfig as JModelConfig
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.launch.train import _preset as jpreset
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss
from repro.optim import make_optimizer as jmake_optimizer

from repro_torch import bridge
from repro_torch.config import ModelConfig, OptimizerConfig
from repro_torch.launch.train import _preset as tpreset
from repro_torch.models.lm import init_lm, lm_loss
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.utils.trees import tree_flatten, tree_unflatten

CPU = torch.device("cpu")
SMALL_QK = dict(name="small_qk", family="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
                qk_norm=True)


def _cfgs(which):
    if which == "lmtiny":
        return jpreset("lmtiny"), tpreset("lmtiny")
    return (JModelConfig(remat=False, dtype="float32", **SMALL_QK),
            ModelConfig(dtype="float32", **SMALL_QK))


def _batch(vocab, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1))
    return toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("which,seq,impl", [
    ("lmtiny", 32, "naive"),
    ("small_qk", 512, "naive"),
    ("small_qk", 512, "blocked"),
])
def test_lm_loss_and_grads_match_reference(which, seq, impl):
    jcfg, tcfg = _cfgs(which)
    params = jax.device_get(jinit_lm(jcfg, jax.random.PRNGKey(0))[0])
    x, y = _batch(jcfg.vocab_size, 2, seq)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(p, {"tokens": jnp.asarray(x, jnp.int32),
                               "targets": jnp.asarray(y, jnp.int32)},
                           jcfg, impl=impl)))(params)

    tp = bridge.from_numpy(params, CPU)
    leaves, treedef = tree_flatten(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tl = lm_loss(tree_unflatten(treedef, leaves),
                 {"tokens": torch.from_numpy(x), "targets": torch.from_numpy(y)},
                 tcfg, impl=impl)
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    # Sums run in another order on each side (matmul blocking, softmax,
    # scatter-add).  Against a float64 run of the port, each side's fp32
    # gradients are off by up to ~1e-5 of the leaf's largest element (the
    # embedding table, summed over token repeats), so: rtol 1e-5 with an
    # absolute floor of 3e-5 of the leaf's largest gradient.
    for got, want in zip(grads, jax.tree.leaves(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=3e-5 * float(np.abs(want).max()))


def test_init_and_bridge_keep_reference_shapes_and_order():
    jcfg, tcfg = _cfgs("small_qk")
    jp = jinit_lm(jcfg, jax.random.PRNGKey(0))[0]
    tp = init_lm(tcfg, 0, CPU)
    jl, tl = jax.tree.leaves(jp), tree_flatten(tp)[0]
    assert [x.shape for x in jl] == [tuple(x.shape) for x in tl]
    # dense_init's fan-in rule: wq (d, H, hd) is scaled by 1/sqrt(H)
    wq = tp["layers"]["mixer"]["wq"]
    assert abs(float(wq.std()) - 1 / np.sqrt(tcfg.num_heads)) < 0.05
    back = bridge.to_numpy(bridge.from_numpy(jax.device_get(jp), CPU))
    for a, b in zip(jax.tree.leaves(back), jl):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_adamw_step_matches_reference():
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(3, 64)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    grads = [{"w": rng.normal(size=(3, 64)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
             for _ in range(3)]
    kw = dict(name="adamw", lr=1e-2, weight_decay=0.01)
    jopt, topt = jmake_optimizer(JOptimizerConfig(**kw)), \
        make_optimizer(OptimizerConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = bridge.from_numpy(params, CPU)
    ts = topt.init(tp)
    for g in grads:
        jp, js = jopt.apply(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = topt.apply(tp, bridge.from_numpy(g, CPU), ts)
    # the bias corrections use pow on each side: an ulp or two apart
    for a, b in zip(tree_flatten(tp)[0], jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
