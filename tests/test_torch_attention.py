"""The port's attention against the JAX reference, on the CPU: the plain
paths, the ``impl="kernel"`` wrapper (which takes the flash kernel's plain
version for a CPU tensor) and the KV-cache decode.

Inputs come from numpy seeds and are handed to both sides.  The
reference's Pallas kernel runs in interpret mode, as its own tests run it.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.config import ModelConfig as JModelConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro.models.layers import split_tree

from repro_torch import bridge
from repro_torch.config import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as A

CPU = torch.device("cpu")
SMALL = dict(name="attn_small", family="dense", num_layers=1, d_model=96,
             num_heads=6, num_kv_heads=2, d_ff=128, vocab_size=64,
             qk_norm=True, dtype="float32")


def _qkv(B, Sq, Skv, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, K, D)).astype(np.float32),
            rng.normal(size=(B, Skv, K, D)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# (B, Sq, Skv, H, K, D): G = 3 where H = 6, K = 2; 37 / 45 are not
# multiples of the 16-row tiles the reference kernel runs with here
SHAPES = [(2, 37, 37, 6, 2, 16), (1, 20, 45, 6, 2, 16), (2, 16, 16, 4, 4, 8)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 16])
def test_kernel_wrapper_matches_reference_flash_contiguous(shape, causal,
                                                           window):
    B, Sq, Skv, H, K, D = shape
    q, k, v = _qkv(B, Sq, Skv, H, K, D)
    want_pallas = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=16, block_k=16))
    want_ref = np.swapaxes(np.asarray(jref.flash_attention_ref(
        *(jnp.swapaxes(jnp.asarray(a), 1, 2) for a in (q, k, v)),
        causal=causal, window=window)), 1, 2)
    tq, tk, tv = _t(q, k, v)
    qpos = torch.arange(Sq, dtype=torch.int32)
    kvpos = torch.arange(Skv, dtype=torch.int32)
    got = ops.flash_attention(tq, tk, tv, qpos, kvpos, causal=causal,
                              window=window).numpy()
    got_impl = A.attention_impl(tq, tk, tv, causal=causal, window=window,
                                impl="kernel").numpy()
    # fp32 on both sides, softmax sums over <= 45 keys in other orders
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=2e-6)
    np.testing.assert_array_equal(got_impl, got)


def _cache_positions(Skv, written, ring_start=None):
    """Slot positions of a cache: slots < written hold 0.., the rest -1;
    with ``ring_start`` a ring buffer whose slot s holds the latest
    position congruent to s."""
    pos = np.full((Skv,), -1, np.int32)
    if ring_start is None:
        pos[:written] = np.arange(written)
    else:
        for p in range(ring_start, ring_start + written):
            pos[p % Skv] = p
    return pos


# (Sq, Skv, q_start, written, window, ring): decode (Sq 1) against a
# linear cache with unwritten slots, prefill into a longer cache, and a
# ring buffer whose slots are out of position order
POSITION_CASES = [
    (1, 40, 29, 30, 0, False),
    (1, 40, 29, 30, 8, False),
    (12, 40, 0, 12, 0, False),
    (12, 40, 0, 12, 5, False),
    (1, 8, 21, 8, 8, True),
]


@pytest.mark.parametrize("case", POSITION_CASES)
def test_attention_with_positions_matches_reference_naive(case):
    Sq, Skv, q_start, written, window, ring = case
    q, k, v = _qkv(2, Sq, Skv, 6, 2, 16, seed=1)
    qpos = np.arange(q_start, q_start + Sq, dtype=np.int32)
    kvpos = _cache_positions(Skv, written,
                             ring_start=q_start - written + 1 if ring
                             else None)
    want = np.asarray(JA.naive_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, window=window,
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kvpos)))
    tq, tk, tv, tqp, tkp = _t(q, k, v, qpos, kvpos)
    kw = dict(causal=True, window=window, q_positions=tqp, kv_positions=tkp)
    # fp32 on both sides: one softmax over <= 40 keys in other orders
    for impl in ("naive", "blocked", "kernel"):
        got = A.attention_impl(tq, tk, tv, impl=impl, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6,
                                   err_msg=impl)
    got = A.blocked_attention(tq, tk, tv, q_chunk=5, kv_chunk=7,
                              **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


# (B, Sq, Skv, H, K, D, q_start, written, window, ring): the split-KV
# decode kernel's algorithm at G 10 (recurrentgemma-2b's MQA), 3 and 1, Sq
# 1 and 16; a ring whose slots are out of position order; a cache whose
# later splits are wholly unwritten; Skv not a multiple of the split size
DECODE_CASES = [
    (2, 1, 300, 10, 1, 16, 299, 300, 0, False),
    (2, 1, 64, 10, 1, 16, 100, 64, 64, True),
    (1, 1, 1024, 6, 2, 32, 40, 41, 0, False),
    (8, 1, 577, 12, 4, 16, 512, 513, 0, False),
    (2, 16, 90, 6, 2, 16, 55, 71, 0, False),
    (2, 16, 70, 4, 4, 16, 50, 66, 8, False),
    (1, 16, 200, 10, 1, 16, 100, 116, 24, False),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_split_decode_matches_plain_and_reference(case):
    B, Sq, Skv, H, K, D, q_start, written, window, ring = case
    q, k, v = _qkv(B, Sq, Skv, H, K, D, seed=5)
    qpos = np.arange(q_start, q_start + Sq, dtype=np.int32)
    kvpos = _cache_positions(Skv, written,
                             ring_start=q_start - written + 1 if ring
                             else None)
    want = np.asarray(JA.naive_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, window=window,
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kvpos)))
    tq, tk, tv, tqp, tkp = _t(q, k, v, qpos, kvpos)
    kw = dict(causal=True, window=window)
    got = fa.flash_decode_plain(tq, tk, tv, tqp, tkp, **kw).numpy()
    plain = fa.flash_attention_plain(tq, tk, tv, tqp, tkp, **kw).numpy()
    # fp32 on both sides: per-split softmaxes over <= 1024 keys and their
    # log-sum-exp combine sum in other orders than one softmax
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=2e-6)


def test_decode_plan_splits_and_skips():
    """The split heuristic at the serving shapes, and the cases above
    reach a ragged last split, several tiles a split and wholly skipped
    splits."""
    assert fa.decode_plan(4, 1, 10, 1, 2048) == (1, 1, 64)
    assert fa.decode_plan(8, 1, 12, 4, 577) == (1, 2, 10)
    assert 577 % (2 * fa.DECODE_TILE)
    groups, per_split, splits = fa.decode_plan(1, 1, 6, 2, 1024)
    runs = fa._tile_runs(torch.tensor([40]), torch.from_numpy(
        _cache_positions(1024, 41)), causal=True, window=0,
        tile=fa.DECODE_TILE)
    assert per_split == 1 and splits == 32
    assert runs.tolist() == [True, True] + [False] * 30
    assert fa.decode_plan(1, 16, 10, 1, 200)[0] == 10   # 160 rows
    assert fa.design(1, 16, torch.float32) == "flash_decode"
    assert fa.design(17, 64, torch.bfloat16) == "flash_prefill"
    assert fa.design(17, 64, torch.float32) == "flash_simt"


def test_reference_pallas_wrapper_drops_decode_positions():
    """The reference's Pallas wrapper takes query i at position i, so a
    decode query (Sq 1) at position 29 sees only cache slot 0; the port's
    wrapper takes the positions and equals the reference's naive path."""
    q, k, v = _qkv(2, 1, 40, 6, 2, 16, seed=2)
    qpos = np.array([29], np.int32)
    kvpos = _cache_positions(40, 30)
    want = np.asarray(JA.naive_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kvpos)))
    pallas = np.asarray(jops.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kvpos),
        block_q=16, block_k=16))
    assert np.abs(pallas - want).max() > 0.1
    np.testing.assert_allclose(pallas, np.repeat(v[:, :1], 3, axis=2),
                               rtol=1e-6, atol=1e-6)
    got = ops.flash_attention(*_t(q, k, v, qpos, kvpos)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


def test_plain_version_is_the_contract():
    """The flash kernel's plain version scales q before q k^T and floors
    the row sum; on a row with visible keys it equals the naive softmax."""
    q, k, v = _qkv(1, 9, 9, 4, 2, 8, seed=3)
    tq, tk, tv = _t(q, k, v)
    pos = torch.arange(9, dtype=torch.int32)
    got = fa.flash_attention_plain(tq, tk, tv, pos, pos, scale=0.3)
    want = A.naive_attention(tq, tk, tv, scale=0.3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)
    assert fa.visible(pos, torch.tensor([-1, 0, 5]), causal=True,
                      window=3).tolist()[5] == [False, False, True]


@pytest.mark.parametrize("window,max_len", [(0, 20), (6, 20)])
@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_decode_attention_matches_reference(window, max_len, impl):
    """Prefill 9 tokens into a linear or ring-buffer cache, then decode 4
    steps: outputs and cache contents equal the reference's."""
    jcfg = JModelConfig(remat=False, **SMALL)
    tcfg = ModelConfig(**SMALL)
    p = jax.device_get(split_tree(JA.init_attention(
        jcfg, jax.random.PRNGKey(1)))[0])
    tp = bridge.from_numpy(p, CPU)
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(2, 13, tcfg.d_model)).astype(np.float32)
    jc = JA.init_kv_cache(jcfg, 2, max_len, window=window,
                          dtype=jnp.float32)
    tc = A.init_kv_cache(tcfg, 2, max_len, window=window,
                         dtype=torch.float32, device="cpu")
    steps = [(0, 9)] + [(t, t + 1) for t in range(9, 13)]
    for a, b in steps:
        jo, jc = JA.decode_attention(p, jnp.asarray(xs[:, a:b]), jc, jcfg,
                                     None, pos=jnp.int32(a), window=window,
                                     impl="naive")
        to, tc = A.decode_attention(tp, torch.from_numpy(xs[:, a:b]), tc,
                                    tcfg, pos=a, window=window, impl=impl)
        # fp32 projections and softmax in other summation orders
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), rtol=1e-4,
                                       atol=1e-5)


def test_cache_overrun_raises():
    tcfg = ModelConfig(**SMALL)
    p = bridge.from_numpy(jax.device_get(split_tree(JA.init_attention(
        JModelConfig(remat=False, **SMALL), jax.random.PRNGKey(1)))[0]), CPU)
    cache = A.init_kv_cache(tcfg, 1, 4, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="overrun"):
        A.decode_attention(p, torch.zeros((1, 5, tcfg.d_model)), cache,
                           tcfg, pos=0)
