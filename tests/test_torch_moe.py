"""The port's MoE block (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the CPU, in fp32, from the reference's own init
(crossed through ``bridge.from_numpy``) and inputs made with numpy.

A one-ulp change of a router input can flip a top-k choice, so the
router's test asserts that its inputs keep every k-th to (k+1)-th
probability margin above 1e-5: a flip is then a fault, not rounding."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import moe as JM
from repro.models.layers import split_tree

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as M

CPU = torch.device("cpu")
ARCHS = ["grok-1-314b", "deepseek-v2-lite-16b"]


def _setup(arch, seed):
    jcfg = dataclasses.replace(jsmoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp, _ = split_tree(JM.init_moe(jcfg, jax.random.PRNGKey(seed)))
    jp = jax.device_get(jp)
    return jcfg, tcfg, jp, bridge.from_numpy(jp, CPU)


def _x(shape, seed, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _margins(jp, x2d, k):
    """The k-th minus the (k+1)-th router probability of every token."""
    logits = x2d.astype(np.float64) @ np.asarray(jp["router"], np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    return p[:, k - 1] - p[:, k]


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_reference(arch):
    jcfg, tcfg, jp, tp = _setup(arch, 0)
    x = _x((56, tcfg.d_model), 1)
    assert _margins(jp, x, tcfg.moe.top_k).min() > 1e-5
    jw, jids = JM._router(jp, jnp.asarray(x), jcfg.moe)
    tw, tids = M._router(tp, torch.from_numpy(x), tcfg.moe)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    # fp32 softmax and renormalisation in other orders: weights <= 1,
    # a few ulps apart
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity", [None, 2])
def test_dispatch_and_combine_match_reference(arch, capacity):
    """Fed the reference's own ``(wk, ids)``: the buckets and the route
    equal, at the computed capacity and at 2 (tokens dropped); the
    combine of one ``y`` within fp32 summation order."""
    jcfg, tcfg, jp, tp = _setup(arch, 2)
    Tg = 40
    x = _x((Tg, tcfg.d_model), 3)
    jw, jids = JM._router(jp, jnp.asarray(x), jcfg.moe)
    if capacity is None:
        capacity = M.capacity_of(tcfg, Tg)
        k, E, cf = jcfg.moe.top_k, jcfg.moe.num_experts, \
            jcfg.moe.capacity_factor
        want = max(min(int((k * Tg / E) * cf + 0.999), Tg), 1)
        assert capacity == ((want + 7) // 8) * 8
    jeb, jroute = JM._dispatch_group(jnp.asarray(x), jw, jids, jp, jcfg,
                                     capacity)
    teb, troute = M._dispatch_group(torch.from_numpy(x),
                                    torch.from_numpy(np.array(jw)),
                                    torch.from_numpy(np.array(jids)),
                                    tcfg, capacity)
    np.testing.assert_array_equal(teb.numpy(), np.asarray(jeb))
    for name, a, b in zip(("slot", "sorted_tok", "sorted_w", "keep"),
                          troute, jroute):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    if capacity == 2:
        assert not bool(troute[3].all())        # some rows dropped
    y = _x(tuple(teb.shape), 4)
    want = JM._combine_group(jnp.asarray(y), jroute, Tg, jnp.float32)
    got = M._combine_group(torch.from_numpy(y), troute, Tg, torch.float32)
    # sums of top_k weighted rows, |y| ~ 0.5: fp32 in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["dense", "sorted"])
def test_moe_matches_reference(arch, impl):
    jcfg, tcfg, jp, tp = _setup(arch, 5)
    x = _x((2, 16, tcfg.d_model), 6)
    assert _margins(jp, x.reshape(32, -1), tcfg.moe.top_k).min() > 1e-5
    jfn = JM.moe_dense if impl == "dense" else JM.moe_sorted
    tfn = M.moe_dense if impl == "dense" else M.moe_sorted
    want = np.asarray(jfn(jp, jnp.asarray(x), jcfg, None))
    got = tfn(tp, torch.from_numpy(x), tcfg).numpy()
    # fp32 einsums over d 64 and ff 32-128 in other orders: outputs ~1,
    # 1e-5 is ~100 ulps
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("groups", [2, 8])
def test_grouped_sorted_moe_matches_reference(groups):
    """``apply_moe(impl="sorted", groups=)`` against the reference's: 36
    tokens in 2 groups of 18, and 8 groups halved to 4 of 9 (the first
    divisor of 36 on the way down), each group with its own capacity."""
    jcfg, tcfg, jp, tp = _setup("deepseek-v2-lite-16b", 8)
    x = _x((2, 18, tcfg.d_model), 9)
    assert _margins(jp, x.reshape(36, -1), tcfg.moe.top_k).min() > 1e-5
    # jitted: the reference's eager dispatch takes ~3 s a call here
    want = np.asarray(jax.jit(lambda p, xx: JM.apply_moe(
        p, xx, jcfg, None, impl="sorted", groups=groups))(jp, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    got = M.apply_moe(tp, xt, tcfg, impl="sorted", groups=groups)
    # as test_moe_matches_reference: fp32 einsums in other orders
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if groups == 8:
        torch.testing.assert_close(got, M.moe_sorted(tp, xt, tcfg, groups=4),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_sorted_matches_dense_at_full_capacity(arch):
    _, tcfg, _, tp = _setup(arch, 0)
    x = torch.from_numpy(_x((2, 16, tcfg.d_model), 1))
    dense = M.moe_dense(tp, x, tcfg)
    srt = M.moe_sorted(tp, x, tcfg, capacity=2 * 16 * tcfg.moe.top_k)
    # no row dropped: the same products, summed in another order
    torch.testing.assert_close(srt, dense, rtol=1e-5, atol=1e-5)
    assert M.apply_moe(tp, x, tcfg).shape == x.shape    # auto: dense


def test_moe_grads_match_reference():
    """Autograd's gradients of the router, the experts' ``wi`` and the
    shared expert against ``jax.grad``, through the sorted dispatch."""
    jcfg, tcfg, jp, tp = _setup("deepseek-v2-lite-16b", 7)
    x = _x((2, 8, tcfg.d_model), 8)
    assert _margins(jp, x.reshape(16, -1), tcfg.moe.top_k).min() > 1e-5

    def jloss(p):
        return jnp.sum(jnp.square(JM.moe_sorted(p, jnp.asarray(x), jcfg,
                                                None)))

    jg = jax.grad(jloss)(jax.tree.map(jnp.asarray, jp))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    torch.sum(torch.square(M.moe_sorted(tp, torch.from_numpy(x), tcfg))) \
        .backward()
    for name in ("router", "wi", "shared_wi"):
        want = np.asarray(jg[name])
        got = tp[name].grad.numpy()
        # fp32 backward through softmax and einsums in other orders:
        # 1e-4 of the gradient's largest magnitude
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
        assert np.abs(want).max() > 0
