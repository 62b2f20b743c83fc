"""The port's RWKV6 against the JAX reference, on the CPU: the exact WKV
recurrence (the WKV6 kernel's plain version) and the time-mix,
channel-mix and group-norm blocks at ``rwkv6-smoke``.

Inputs come from numpy seeds and are handed to both sides; the reference's
Pallas WKV kernel runs in interpret mode, as its own tests run it.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jsmoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rwkv as JR
from repro.models.layers import split_tree

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import rwkv as R

CPU = torch.device("cpu")


def _wkv_inputs(B, T, H, D, log_w_mean, seed=0, state=True):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.normal(size=(B, T, H, D)).astype(np.float32)
               for _ in range(3))
    # log_w = -exp(z): z ~ log(-log_w_mean) + 0.3 N(0, 1)
    z = np.log(-log_w_mean) + 0.3 * rng.normal(size=(B, T, H, D))
    log_w = (-np.exp(z)).astype(np.float32)
    u = (0.3 * rng.normal(size=(H, D))).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(B, H, D, D)) if state
          else np.zeros((B, H, D, D))).astype(np.float32)
    return r, k, v, log_w, u, s0


def _bhtd(a):
    return jnp.swapaxes(jnp.asarray(a), 1, 2)


def _port_wkv(args):
    y, s = ops.wkv6(*(torch.from_numpy(a) for a in args))
    return y.numpy(), s.numpy()


@pytest.mark.parametrize("B,T,H,D", [(2, 1, 2, 16), (1, 70, 2, 16),
                                     (2, 33, 3, 8)])
@pytest.mark.parametrize("log_w_mean", [-0.1, -1.0, -5.0])
def test_wkv_matches_reference_exact_recurrence(B, T, H, D, log_w_mean):
    args = _wkv_inputs(B, T, H, D, log_w_mean)
    r, k, v, log_w, u, s0 = args
    y_ref, s_ref = jref.wkv6_ref(_bhtd(r), _bhtd(k), _bhtd(v), _bhtd(log_w),
                                 jnp.asarray(u), jnp.asarray(s0))
    y_scan, s_scan = JR.wkv_scan(*(jnp.asarray(a) for a in args))
    y, s = _port_wkv(args)
    # fp32 step by step on both sides; the D-term sums run in other orders
    np.testing.assert_allclose(y, np.swapaxes(np.asarray(y_ref), 1, 2),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s, np.asarray(s_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y, np.asarray(y_scan), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s, np.asarray(s_scan), rtol=1e-5, atol=1e-6)


def test_wkv_carried_state_equals_one_pass():
    """Two calls that carry the state equal one call over both halves."""
    args = _wkv_inputs(2, 70, 2, 16, -1.0, seed=1)
    y, s = _port_wkv(args)
    first = [a[:, :29] for a in args[:4]] + list(args[4:])
    y1, s1 = _port_wkv(first)
    y2, s2 = _port_wkv([a[:, 29:] for a in args[:4]] + [args[4], s1])
    np.testing.assert_allclose(np.concatenate([y1, y2], axis=1), y,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(s2, s, rtol=1e-6, atol=1e-7)


def test_wkv_matches_reference_pallas_at_weak_decay():
    """At log_w ~ -0.1 the reference's chunked kernel's +-30 clamp does not
    bind over a 64-step chunk, and the port equals it."""
    args = _wkv_inputs(1, 70, 2, 16, -0.1, seed=2)
    jy, js = jops.wkv6(*(jnp.asarray(a) for a in args))
    y, s = _port_wkv(args)
    # the chunked matmul form sums in another association (exp of
    # cumulative log-decays): the reference's own kernel tests allow 5e-4
    np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(s, np.asarray(js), rtol=1e-4, atol=5e-4)


def test_port_is_exact_where_reference_chunked_is_off():
    """At the model's own decay (log_w ~ -1) the reference's chunked form
    (its prefill path beyond 64 tokens) is far from the exact recurrence;
    the port's WKV is not."""
    args = _wkv_inputs(1, 128, 2, 16, -1.0, seed=3)
    jargs = [jnp.asarray(a) for a in args]
    y_exact, _ = JR.wkv_scan(*jargs)
    y_chunk, _ = JR.wkv_chunked(*jargs)
    y, _ = _port_wkv(args)
    scale = float(np.abs(np.asarray(y_exact)).max())
    assert float(np.abs(np.asarray(y_chunk) - np.asarray(y_exact)).max()) \
        > 0.1 * scale
    np.testing.assert_allclose(y, np.asarray(y_exact), rtol=1e-5,
                               atol=1e-6 * scale)


def _perturbed(tree, seed):
    """The reference's init with every zero-initialised vector replaced by
    a small random one, so mu, decay_base, bonus_u and the norms' biases
    take part in the comparison."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, a in tree.items():
        a = np.asarray(a)
        if not a.any():
            a = (0.3 * rng.normal(size=a.shape)).astype(np.float32)
        out[name] = a
    return out


def _blocks(seed=0):
    jcfg, tcfg = jsmoke("rwkv6-3b"), get_smoke_config("rwkv6-3b")
    tm = _perturbed(jax.device_get(split_tree(
        JR.init_time_mix(jcfg, jax.random.PRNGKey(seed)))[0]), seed)
    cm = _perturbed(jax.device_get(split_tree(
        JR.init_channel_mix(jcfg, jax.random.PRNGKey(seed + 1)))[0]), seed)
    return jcfg, tcfg, tm, cm


# fp32: the same operations in other summation orders.  bf16: each side
# rounds every matmul and elementwise result to bf16 (2^-8 relative) in
# its own order, and about five such roundings chain through a block, so
# 2^-5 of the output's largest magnitude.
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2 ** -5, 2 ** -5)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_reference(dtype, with_state):
    jcfg, tcfg, tm, _ = _blocks()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.default_rng(5)
    B, T, d = 2, 11, tcfg.d_model
    x = (0.5 * rng.normal(size=(B, T, d))).astype(np.float32)
    jstate = tstate = None
    if with_state:
        st = {"wkv": (0.1 * rng.normal(size=(B, tcfg.num_heads,
                                             tcfg.resolved_head_dim,
                                             tcfg.resolved_head_dim))
                      ).astype(np.float32),
              "tm_x": (0.5 * rng.normal(size=(B, d))).astype(np.float32)}
        jstate = {"wkv": jnp.asarray(st["wkv"]),
                  "tm_x": jnp.asarray(st["tm_x"]).astype(jdt)}
        tstate = {"wkv": torch.from_numpy(st["wkv"]),
                  "tm_x": torch.from_numpy(st["tm_x"]).to(tdt)}
    jo, js = JR.apply_time_mix(tm, jnp.asarray(x).astype(jdt), jcfg, None,
                               state=jstate, impl="scan")
    tp = bridge.from_numpy(tm, CPU)
    for impl in ("scan", "kernel"):
        to, ts = R.apply_time_mix(tp, torch.from_numpy(x).to(tdt), tcfg,
                                  state=tstate, impl=impl)
        assert to.dtype == tdt
        want = np.asarray(jo.astype(jnp.float32))
        rtol, atol = TOL[dtype]
        np.testing.assert_allclose(to.float().numpy(), want, rtol=rtol,
                                   atol=atol * float(np.abs(want).max()))
        if with_state:
            np.testing.assert_allclose(
                ts["wkv"].numpy(), np.asarray(js["wkv"]), rtol=rtol,
                atol=atol * float(np.abs(np.asarray(js["wkv"])).max()))
            np.testing.assert_array_equal(
                ts["tm_x"].float().numpy(),
                np.asarray(js["tm_x"].astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_reference(dtype):
    jcfg, tcfg, _, cm = _blocks(seed=2)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.default_rng(6)
    x = (0.5 * rng.normal(size=(2, 7, tcfg.d_model))).astype(np.float32)
    prev = (0.5 * rng.normal(size=(2, tcfg.d_model))).astype(np.float32)
    jo, js = JR.apply_channel_mix(cm, jnp.asarray(x).astype(jdt), jcfg, None,
                                  state={"cm_x": jnp.asarray(prev)})
    to, ts = R.apply_channel_mix(bridge.from_numpy(cm, CPU),
                                 torch.from_numpy(x).to(tdt),
                                 state={"cm_x": torch.from_numpy(prev)})
    want = np.asarray(jo.astype(jnp.float32))
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(to.float().numpy(), want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()))
    np.testing.assert_array_equal(ts["cm_x"].float().numpy(),
                                  np.asarray(js["cm_x"].astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_reference(dtype):
    rng = np.random.default_rng(7)
    y = (2.0 * rng.normal(size=(2, 5, 2, 32)) + 0.5).astype(np.float32)
    scale = (1 + 0.3 * rng.normal(size=(64,))).astype(np.float32)
    bias = (0.3 * rng.normal(size=(64,))).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(JR._group_norm(jnp.asarray(y).astype(jdt),
                                     jnp.asarray(scale), jnp.asarray(bias))
                      .astype(jnp.float32))
    got = R._group_norm(torch.from_numpy(y).to(tdt), torch.from_numpy(scale),
                        torch.from_numpy(bias)).float().numpy()
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()))


def test_time_mix_rejects_unknown_impl():
    _, tcfg, tm, _ = _blocks()
    with pytest.raises(ValueError, match="chunked"):
        R.apply_time_mix(bridge.from_numpy(tm, CPU),
                         torch.zeros((1, 2, tcfg.d_model)), tcfg,
                         impl="chunked")
