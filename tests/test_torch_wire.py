"""The port's int4 wire against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.  The
reference's Pallas kernels run in interpret mode (``repro.kernels.ops``
off-TPU); the port's CPU tensors take the plain PyTorch versions, which
are what the CUDA kernels are held to on the card.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.dist import compression as jcomp
from repro.dist import wire as jwire
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.train import _preset as jpreset
from repro.models import init_lm as jinit_lm

from repro_torch.dist import compression as tcomp
from repro_torch.dist import wire as twire
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from torch_parity import jax_noise
from torch_parity import to_numpy as _n
from torch_parity import to_torch as _t


# ---------------------------------------------------------------------------
# pack / unpack / tail / canonicalize: exact
# ---------------------------------------------------------------------------

PACK_CASES = [
    ((256,), 0),
    ((3, 512, 5), 1),           # middle blocked axis
    ((2, 7, 256), 2),           # last axis
    ((1024, 3), 0),             # leading axis
    ((3, 2, 768, 3, 4), 2),     # stacked-wq-like: odd pods, middle axis
]


@pytest.mark.parametrize("shape,axis", PACK_CASES)
def test_pack_unpack_exact_vs_reference(shape, axis):
    q = np.random.default_rng(sum(shape)).integers(-8, 8, size=shape,
                                                   dtype=np.int8)
    want = np.asarray(jref.pack_nibbles_ref(jnp.asarray(q), axis=axis))
    np.testing.assert_array_equal(np.asarray(
        jops.pack_int4(jnp.asarray(q), axis=axis)), want)  # interpret mode
    got = tops.pack_int4(_t(q), axis=axis)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(_n(got), want)
    np.testing.assert_array_equal(_n(tref.pack_nibbles_ref(_t(q), axis)), want)
    back = tops.unpack_int4(_t(want), axis=axis)
    np.testing.assert_array_equal(_n(back), q)
    np.testing.assert_array_equal(
        _n(back), np.asarray(jops.unpack_int4(jnp.asarray(want), axis=axis)))


@pytest.mark.parametrize("rem", [1, 2, 5, 64, 127, 128, 255])
@pytest.mark.parametrize("axis", [0, 1])
def test_tail_and_canonicalize_exact(rem, axis):
    rng = np.random.default_rng(rem)
    shape = [3, 3]
    shape[axis] = 256 + rem
    q = rng.integers(-8, 8, size=shape, dtype=np.int8)
    tail = np.take(q, np.arange(256, 256 + rem), axis=axis)
    want_t = np.asarray(jref.pack_tail_ref(jnp.asarray(tail), axis=axis))
    np.testing.assert_array_equal(_n(tref.pack_tail_ref(_t(tail), axis)),
                                  want_t)
    np.testing.assert_array_equal(
        _n(tref.unpack_tail_ref(_t(want_t), rem, axis)), tail)
    head = np.take(q, np.arange(256), axis=axis)
    wire = np.concatenate([np.asarray(jref.pack_nibbles_ref(
        jnp.asarray(head), axis=axis)), want_t], axis=axis)
    want_c = np.asarray(jref.canonicalize_packed_ref(jnp.asarray(wire),
                                                     256 + rem, axis=axis))
    got_c = tref.canonicalize_packed_ref(_t(wire), 256 + rem, axis=axis)
    np.testing.assert_array_equal(_n(got_c), want_c)


# ---------------------------------------------------------------------------
# the two merges
# ---------------------------------------------------------------------------

def _merge_scalars(rng, n_pods, any_push):
    w2 = (rng.uniform(0.2, 1.0, n_pods) * (rng.random(n_pods) < 0.8)
          ).astype(np.float32)
    w1 = np.float32(rng.uniform(0.1, 1.0))
    denom = np.float32(w1 + w2.sum(dtype=np.float32))
    return w1, w2, denom, np.bool_(any_push)


@pytest.mark.parametrize("g_shape,n_pods,any_push", [
    ((4, 512), 2, True), ((3, 300), 3, True), ((2, 768, 5), 4, True),
    ((5, 64), 3, True), ((3, 300), 3, False),
])
def test_dequant_merge_packed_plain_vs_reference(g_shape, n_pods, any_push):
    rng = np.random.default_rng(len(g_shape) * 10 + n_pods)
    g = rng.normal(size=g_shape).astype(np.float32)
    fmt = jwire.get_format("int4")
    delta = rng.normal(size=(n_pods,) + g_shape).astype(np.float32)
    pay = fmt.encode(jnp.asarray(delta), rng=jax.random.PRNGKey(3))
    ax = jwire.block_axis((n_pods,) + g_shape)
    _, w2, denom, push = _merge_scalars(rng, n_pods, any_push)
    want = np.asarray(jref.dequant_merge_packed_ref(
        jnp.asarray(g), pay["q_packed"], pay["scales"], jnp.asarray(w2),
        jnp.asarray(denom), jnp.asarray(push), axis=ax))
    got = tops.dequant_merge_packed(
        _t(g), _t(pay["q_packed"]), _t(pay["scales"]), _t(w2),
        torch.tensor(denom), torch.tensor(push), axis=ax)
    # both sides run one rounding per op in the same order: bitwise
    np.testing.assert_array_equal(_n(got), want)


@pytest.mark.parametrize("shape,n_pods", [((4, 4096), 2), ((3, 1000), 3),
                                          ((17,), 4)])
@pytest.mark.parametrize("any_push", [True, False])
def test_loss_weighted_update_plain_vs_reference(shape, n_pods, any_push):
    rng = np.random.default_rng(n_pods)
    g = rng.normal(size=shape).astype(np.float32)
    pods = rng.normal(size=(n_pods,) + shape).astype(np.float32)
    w1, w2, denom, push = _merge_scalars(rng, n_pods, any_push)
    args = (w1, w2, denom, push)
    want = np.asarray(jref.loss_weighted_update_ref(
        jnp.asarray(g), jnp.asarray(pods), *map(jnp.asarray, args)))
    got = tops.loss_weighted_update(_t(g), _t(pods),
                                    *map(torch.tensor, args))
    np.testing.assert_array_equal(_n(got), want)
    kern = np.asarray(jops.loss_weighted_update(
        jnp.asarray(g), jnp.asarray(pods), *map(jnp.asarray, args)))
    # the reference's own kernel may contract a multiply-add into an FMA
    # inside its compiled tile loop (one rounding fewer per pod): bound the
    # gap by 2 ulps of the largest term each element sums, not of the sum,
    # which may cancel to near zero
    terms = (np.abs(w1 * g) + np.tensordot(w2, np.abs(pods), 1)) / denom
    assert np.all(np.abs(_n(got) - kern) <= 2 * np.finfo(np.float32).eps
                  * (n_pods + 1) * terms + 1e-30)


# ---------------------------------------------------------------------------
# block_axis and the int4 encode
# ---------------------------------------------------------------------------

def _leaf_shapes(preset, n_pods=4):
    shapes = jax.eval_shape(
        lambda: jinit_lm(jpreset(preset), jax.random.PRNGKey(0))[0])
    return [(n_pods,) + tuple(s.shape) for s in jax.tree.leaves(shapes)]


@pytest.mark.parametrize("preset", ["lmtiny", "lm100m"])
def test_block_axis_matches_reference_on_every_leaf(preset):
    for shape in _leaf_shapes(preset):
        assert twire.block_axis(shape) == jwire.block_axis(shape), shape
        assert twire.block_axis(shape[1:]) == jwire.block_axis(shape[1:])


@pytest.mark.parametrize("shape", [(4, 768, 3, 8), (3, 2, 64), (2, 300)])
def test_int4_encode_with_injected_noise_matches_reference(shape):
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(
        np.float32)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), 3), 2)
    want = jwire.get_format("int4").encode(jnp.asarray(x), rng=key)
    got = twire.get_format("int4").encode(_t(x), key=(3, 2),
                                          noise=jax_noise(7))
    np.testing.assert_array_equal(_n(got["q_packed"]),
                                  np.asarray(want["q_packed"]))
    np.testing.assert_array_equal(_n(got["scales"]),
                                  np.asarray(want["scales"]))
    dec = twire.get_format("int4").decode(got, shape, torch.float32)
    np.testing.assert_array_equal(_n(dec), np.asarray(
        jwire.get_format("int4").decode(want, shape, jnp.float32)))


def test_int4_generator_noise_rounding_is_unbiased():
    """The port's own noise: E[decode(encode(x))] = x within the Monte-Carlo
    error, and one (round, leaf) always draws the same bits."""
    fmt = twire.get_format("int4")
    x = torch.linspace(-1.0, 1.0, 512)
    noise = twire.GeneratorNoise(0, torch.device("cpu"))
    recs = torch.stack([fmt.decode(fmt.encode(x, key=(r, 0), noise=noise),
                                   x.shape, x.dtype) for r in range(400)])
    scale = 1.0 / 7.0
    # per-element std of one draw <= scale/2; 400 draws -> 5 sigma
    assert float((recs.mean(0) - x).abs().max()) < 5 * (scale / 2) / 20
    a = fmt.encode(x, key=(5, 1), noise=noise)["q_packed"]
    b = fmt.encode(x, key=(5, 1), noise=noise)["q_packed"]
    assert torch.equal(a, b)


def test_encode_tree_residuals_match_reference():
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(3, 512)).astype(np.float32),
            "b": {"c": rng.normal(size=(3, 2, 70)).astype(np.float32)}}
    err = {"a": 0.01 * rng.normal(size=(3, 512)).astype(np.float32),
           "b": {"c": 0.01 * rng.normal(size=(3, 2, 70)).astype(np.float32)}}
    jt = jax.tree.map(jnp.asarray, tree)
    je = jax.tree.map(jnp.asarray, err)
    rng_key = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    jp, jr, jerr = jcomp.encode_tree(jt, "int4", error=je, rng=rng_key)
    tt = {"a": _t(tree["a"]), "b": {"c": _t(tree["b"]["c"])}}
    te = {"a": _t(err["a"]), "b": {"c": _t(err["b"]["c"])}}
    tp, tr, terr = tcomp.encode_tree(tt, "int4", error=te, round_step=4,
                                     noise=jax_noise(11))
    for key in ("q_packed", "scales"):
        np.testing.assert_array_equal(_n(tp["a"][key]),
                                      np.asarray(jp["a"][key]))
        np.testing.assert_array_equal(_n(tp["b"]["c"][key]),
                                      np.asarray(jp["b"]["c"][key]))
    np.testing.assert_array_equal(_n(terr["a"]), np.asarray(jerr["a"]))
    np.testing.assert_array_equal(_n(terr["b"]["c"]),
                                  np.asarray(jerr["b"]["c"]))
    dec = tcomp.decode_tree(tp, tt, "int4")
    np.testing.assert_array_equal(_n(dec["a"]), _n(tr["a"]))


def test_wire_kernels_reject_cuda_less_calls():
    """The CUDA wrappers refuse CPU tensors instead of falling back."""
    from repro_torch.kernels import pack
    with pytest.raises(ValueError, match="CUDA"):
        pack.pack_int4_cuda(torch.zeros(256, dtype=torch.int8))
