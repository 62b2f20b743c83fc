"""Multi-head Latent Attention (``repro_torch.models.attention``: MLA) and
the flash kernels' plain versions at MLA's head dims, against the JAX
reference on the CPU, in fp32.

MLA attends at ``D = nope + rope`` against ``Dv = v_head_dim``: 24 / 16 in
dsv2-smoke, 192 / 128 in deepseek-v2-lite.  Parameters come from the
reference's init through ``bridge.from_numpy``; inputs from numpy seeds.
The reference's Pallas kernel runs in interpret mode, as its own tests
run it; its wrapper drops the positions, so it is compared on causal
prefill with contiguous positions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jsmoke
from repro.kernels import ops as jops
from repro.models import attention as JA
from repro.models.layers import split_tree

from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as A
from repro_torch.utils.trees import tree_map

CPU = torch.device("cpu")


def _cfgs():
    return (dataclasses.replace(jsmoke("deepseek-v2-lite-16b"),
                                dtype="float32"),
            dataclasses.replace(get_smoke_config("deepseek-v2-lite-16b"),
                                dtype="float32"))


def _params(jcfg, seed):
    jp, _ = split_tree(JA.init_mla(jcfg, jax.random.PRNGKey(seed)))
    jp = jax.device_get(jp)
    return jp, bridge.from_numpy(jp, CPU)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("full", [False, True])
def test_init_mla_tree_shapes(full):
    """The port's tree, leaf for leaf, has the reference's shapes, at the
    smoke size and at deepseek-v2-lite's (shapes only: ``eval_shape`` and
    the ``meta`` device)."""
    arch = "deepseek-v2-lite-16b"
    jcfg = jget_config(arch) if full else jsmoke(arch)
    tcfg = get_config(arch) if full else get_smoke_config(arch)
    want = jax.eval_shape(
        lambda: split_tree(JA.init_mla(jcfg, jax.random.PRNGKey(0)))[0])
    gen = torch.Generator().manual_seed(0)
    got = A.init_mla(tcfg, gen, "meta" if full else CPU)
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[name].shape), name
    if full:
        assert tuple(got["wq"].shape) == (2048, 16, 192)
        assert tuple(got["w_uv"].shape) == (512, 16, 128)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_apply_mla_matches_reference(impl):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 1)
    x = _x((2, 12, tcfg.d_model), 2)
    pos = np.arange(12)
    want = np.asarray(JA.apply_mla(jp, jnp.asarray(x), jcfg, None,
                                   positions=jnp.asarray(pos),
                                   impl="naive"))
    got = A.apply_mla(tp, torch.from_numpy(x), tcfg,
                      positions=torch.from_numpy(pos), impl=impl).numpy()
    assert got.shape == (2, 12, tcfg.d_model)
    # fp32 projections, RoPE and a softmax over <= 12 keys in other
    # orders: outputs ~1, 1e-5 is ~100 ulps
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_decode_mla_matches_forward(impl):
    """A 7-token prefill into the latent cache, then single-token decode,
    equals the full forward at every position (the reference's
    ``test_decode_matches_forward``), and the reference's decode."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 3)
    T, n = 12, 7
    x = torch.from_numpy(_x((2, T, tcfg.d_model), 4))
    full = A.apply_mla(tp, x, tcfg, positions=torch.arange(T),
                       impl="naive")
    cache = A.init_mla_cache(tcfg, 2, T + 2, dtype=torch.float32,
                             device="cpu")
    jcache = JA.init_mla_cache(jcfg, 2, T + 2, dtype=jnp.float32)
    out, cache = A.decode_mla(tp, x[:, :n], cache, tcfg, pos=0, impl=impl)
    jout, jcache = JA.decode_mla(jp, jnp.asarray(x[:, :n].numpy()), jcache,
                                 jcfg, None, pos=jnp.int32(0), impl="naive")
    # fp32 in other orders (the plain split-KV decode rescales per 32-key
    # tile): outputs reach ~5, so 4e-5 is ~60 ulps of the largest
    tol = dict(rtol=1e-5, atol=4e-5)
    torch.testing.assert_close(out, full[:, :n], **tol)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **tol)
    for t in range(n, T):
        out, cache = A.decode_mla(tp, x[:, t:t + 1], cache, tcfg, pos=t,
                                  impl=impl)
        jout, jcache = JA.decode_mla(jp, jnp.asarray(x[:, t:t + 1].numpy()),
                                     jcache, jcfg, None, pos=jnp.int32(t),
                                     impl="naive")
        torch.testing.assert_close(out, full[:, t:t + 1], **tol,
                                   msg=f"position {t}")
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **tol)
    assert cache["pos"].tolist() == list(range(T)) + [-1, -1]
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=1e-5,
                                   atol=1e-5)


# (D, Dv): dsv2-smoke's and deepseek-v2-lite's nope + rope against v
DIMS = [(24, 16), (192, 128)]


def _mla_qkv(B, Sq, Skv, H, K, D, Dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, K, D)).astype(np.float32),
            rng.standard_normal((B, Skv, K, Dv)).astype(np.float32))


@pytest.mark.parametrize("D,Dv", DIMS)
@pytest.mark.parametrize("Sq", [37, 16])
def test_flash_plain_matches_reference_pallas(D, Dv, Sq):
    """Causal prefill at contiguous positions: the plain flash and the
    plain split-KV decode (the decode kernels' algorithm, run here at Sq
    16, the most rows a head it serves) against the reference's Pallas
    kernel in interpret mode."""
    q, k, v = _mla_qkv(1, Sq, Sq, 4, 2, D, Dv, 5)
    scale = D ** -0.5
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        scale=scale, block_q=16, block_k=16))
    pos = torch.arange(Sq, dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = fa.flash_attention_plain(tq, tk, tv, pos, pos, scale=scale)
    assert plain.shape == (1, Sq, 4, Dv)
    # fp32 softmax over <= 37 keys in other orders: outputs are means of
    # N(0, 1) values, 2e-6 absolute is ~20 ulps
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=2e-6)
    if Sq <= fa.DECODE_MAX_SQ:
        dec = fa.flash_decode_plain(tq, tk, tv, pos, pos, scale=scale)
        np.testing.assert_allclose(dec.numpy(), want, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("D,Dv", DIMS)
def test_flash_plain_matches_naive_in_decode(D, Dv):
    """Decode at position 70 of a 100-slot cache with 71 slots written: the
    plain flash, the plain split-KV decode (its partials ``Dv`` wide) and
    the reference's ``naive_attention`` with the positions."""
    q, k, v = _mla_qkv(2, 1, 100, 4, 4, D, Dv, 6)
    qpos = np.array([70], np.int32)
    kvpos = np.where(np.arange(100) < 71, np.arange(100), -1).astype(np.int32)
    scale = D ** -0.5
    want = np.asarray(JA.naive_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kvpos),
        scale=scale))
    tq, tk, tv, tqp, tkp = (torch.from_numpy(a)
                            for a in (q, k, v, qpos, kvpos))
    part_ml, part_acc = fa.decode_split_plain(tq, tk, tv, tqp, tkp,
                                              scale=scale)
    assert part_acc.shape[-1] == Dv and part_ml.shape[:-1] == \
        part_acc.shape[:-1]
    for got in (fa.flash_attention_plain(tq, tk, tv, tqp, tkp, scale=scale),
                fa.decode_combine_plain(part_ml, part_acc, torch.float32)):
        assert got.shape == (2, 1, 4, Dv)
        # fp32 over 71 keys in other orders, as above
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-6)


def test_mla_cache_tree_crosses_the_bridge():
    """The latent cache (and the MLA tree) cross ``bridge`` unchanged."""
    jcfg, tcfg = _cfgs()
    jcache = jax.device_get(JA.init_mla_cache(jcfg, 2, 5,
                                              dtype=jnp.bfloat16))
    tcache = bridge.from_numpy(jcache, CPU)
    assert tcache["c_kv"].dtype == torch.bfloat16
    assert tcache["pos"].dtype == torch.int32
    back = bridge.to_numpy(tcache)
    for name in ("c_kv", "k_rope", "pos"):
        np.testing.assert_array_equal(back[name],
                                      np.asarray(jcache[name], np.float32)
                                      if name != "pos" else jcache[name])
    jp, tp = _params(jcfg, 0)
    tree_map(lambda a, b: np.testing.assert_array_equal(a, b),
             bridge.to_numpy(tp), jp)
