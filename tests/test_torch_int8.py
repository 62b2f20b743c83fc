"""The port's int8 wire, int8 merge and flat int8 quantize against the JAX
reference, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.  The
reference's Pallas kernels run in interpret mode (``repro.kernels.ops``
off-TPU); the port's CPU tensors take the plain PyTorch versions, which
are what the CUDA kernels are held to on the card.  Each port function is
held against the reference path that is sound for it:

* the int8 merge follows the Pallas kernel's order (``denom*g``, then the
  pods one by one); the reference's oracle ``dequant_merge_ref`` sums the
  pods with a tensordot, so both comparisons allow ``atol=1e-5``;
* the flat quantize equals ``quantize_int8_ref`` (true division by 127)
  bit for bit; the Pallas kernel multiplies by ``1/127`` in interpret
  mode, so against it a scale may differ by one ulp;
* the Pallas dequantize writes only ``rows // 64 * 64`` rows, so it is a
  yardstick only where the row count is a multiple of 64.
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

from repro_torch.dist import compression as tcomp
from repro_torch.dist import wire as twire
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from torch_parity import leaf_shapes
from torch_parity import to_numpy as _n
from torch_parity import to_torch as _t

# the shapes of the reference's own int8 merge test (test_kernels.py)
MERGE_SHAPES = [(256,), (300,), (7, 130), (512, 300), (3, 5, 300)]


def _merge_inputs(shape, n_pods, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=shape).astype(np.float32)
    delta = (0.1 * rng.normal(size=(n_pods,) + shape)).astype(np.float32)
    w2 = np.abs(rng.normal(size=n_pods)).astype(np.float32)
    denom = np.float32(0.7 + w2.sum(dtype=np.float32))
    return g, delta, w2, denom


@pytest.mark.parametrize("shape", MERGE_SHAPES)
@pytest.mark.parametrize("n_pods", [1, 3])
def test_dequant_merge_plain_vs_reference(shape, n_pods):
    g, delta, w2, denom = _merge_inputs(shape, n_pods, len(shape) + n_pods)
    pay = jwire.get_format("int8").encode(jnp.asarray(delta))
    ax = jwire.block_axis((n_pods,) + shape)
    for push in (True, False):
        got = _n(tops.dequant_merge(
            _t(g), _t(pay["q"]), _t(pay["scales"]), _t(w2),
            torch.tensor(denom), torch.tensor(push), axis=ax))
        jargs = (jnp.asarray(g), pay["q"], pay["scales"], jnp.asarray(w2),
                 jnp.asarray(denom), jnp.asarray(push))
        kern = np.asarray(jops.dequant_merge(*jargs, axis=ax))
        oracle = np.asarray(jref.dequant_merge_ref(*jargs, axis=ax))
        # another association of one fp32 sum: the oracle's tensordot, and
        # the Pallas kernel's loop, where XLA may contract a multiply-add
        # into an FMA (the reference's own test allows the same 1e-5)
        np.testing.assert_allclose(got, kern, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5)
        if not push:
            np.testing.assert_array_equal(got, g)


@pytest.mark.parametrize("shape", MERGE_SHAPES)
@pytest.mark.parametrize("n_pods", [1, 3])
def test_dequant_merge_plain_equals_packed_merge_on_int4(shape, n_pods):
    """On an int4 payload unpacked to int8, the int8 merge is the packed
    merge op for op: bitwise."""
    g, delta, w2, denom = _merge_inputs(shape, n_pods, 7 * len(shape))
    fmt = twire.get_format("int4")
    stacked = (n_pods,) + shape
    pay = fmt.encode(_t(delta), key=(1, 0),
                     noise=twire.GeneratorNoise(3, torch.device("cpu")))
    q = fmt.unpack_payload(pay, stacked)
    assert tuple(q.shape) == stacked and q.dtype == torch.int8
    ax = twire.block_axis(stacked)
    args = (_t(w2), torch.tensor(denom), torch.tensor(True))
    got = tops.dequant_merge(_t(g), q, pay["scales"], *args, axis=ax)
    want = tref.dequant_merge_packed_ref(_t(g), pay["q_packed"],
                                         pay["scales"], *args, axis=ax)
    assert torch.equal(got, want)


def _cut(shape):
    """A stacked leaf shape with its blocked axis and pod axis kept and
    every other axis cut to at most 3, so block_axis picks the same axis
    and the blocks keep their layout."""
    ax = jwire.block_axis(shape)
    cut = tuple(n if i in (0, ax) else min(n, 3) for i, n in enumerate(shape))
    assert jwire.block_axis(cut) == ax
    return cut


@pytest.mark.parametrize("preset", ["lmtiny", "lm100m"])
def test_int8_encode_decode_match_reference_on_every_leaf(preset):
    """Every leaf shape of the preset stacked 4 pods deep; lmtiny at full
    size, lm100m with its non-blocked axes cut (its full 4-pod tree is
    2 GB of fp32), blocked axis and pods intact."""
    shapes = leaf_shapes(preset)
    if preset == "lm100m":
        shapes = [_cut(s) for s in shapes]
    jfmt, tfmt = jwire.get_format("int8"), twire.get_format("int8")
    rng = np.random.default_rng(5)
    for shape in shapes:
        x = rng.normal(size=shape).astype(np.float32)
        want = jfmt.encode(jnp.asarray(x))
        got = tfmt.encode(_t(x))
        assert set(got) == set(want) == {"q", "scales"}
        for k in ("q", "scales"):
            np.testing.assert_array_equal(_n(got[k]), np.asarray(want[k]),
                                          err_msg=f"{shape} {k}")
        np.testing.assert_array_equal(
            _n(tfmt.decode(got, shape, torch.float32)),
            np.asarray(jfmt.decode(want, shape, jnp.float32)))


def test_int8_rounds_half_to_even_and_takes_no_noise():
    """q = round(x/scale) with ties to even, as torch.round and jnp.round;
    the format ignores any noise it is handed."""
    x = torch.zeros(256)
    x[0] = 127.0                          # scale 1.0 exactly
    x[1:7] = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 126.5])
    fmt = twire.get_format("int8")
    p = fmt.encode(x, key=(3, 1), noise=lambda *a: 1 / 0)
    assert p["q"][:7].tolist() == [127, 0, 2, 2, 0, -2, 126]
    assert float(p["scales"][0]) == 1.0


@pytest.mark.parametrize("n", [256, 1000, 25617, 70000])
def test_flat_quantize_bitwise_vs_reference_ref_path(n):
    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    x[:256] *= 1e-14  # an all-tiny block: its scale floors at 1e-12
    jq, js = jcomp.quantize_int8(jnp.asarray(x))  # CPU: the jnp ref path
    tq, ts = tcomp.quantize_int8(_t(x))
    nb = -(-n // 256)
    assert tuple(tq.shape) == (nb, 256) and tuple(ts.shape) == (nb, 1)
    np.testing.assert_array_equal(_n(tq), np.asarray(jq))
    np.testing.assert_array_equal(_n(ts), np.asarray(js))
    back = tcomp.dequantize_int8(tq, ts, (n,))
    np.testing.assert_array_equal(
        _n(back), np.asarray(jcomp.dequantize_int8(jq, js, (n,))))
    # blockwise absmax error bound: half a quantum per element, plus one
    # fp32 rounding of |x| each for x/scale and q*scale
    bound = np.repeat(_n(ts)[:, 0], 256)[:n] * 0.5
    eps = np.finfo(np.float32).eps
    assert np.all(np.abs(_n(back) - x) <= bound + 2 * eps * np.abs(x))


@pytest.mark.parametrize("n", [256, 1000, 25617, 70000])
def test_flat_quantize_vs_pallas_kernel_on_real_rows(n):
    x = np.random.default_rng(n + 1).normal(size=(n,)).astype(np.float32)
    kq, ks = jops.quantize_int8(jnp.asarray(x))  # interpret mode
    nb = -(-n // 256)
    kq, ks = np.asarray(kq)[:nb], np.asarray(ks)[:nb]  # drop its row padding
    tq, ts = (_n(a) for a in tops.quantize_int8(_t(x)))
    # the Pallas kernel's scale is max|x| * (1/127), the port's max|x| / 127:
    # at most one ulp apart, and where they differ a q may round the other
    # way; elsewhere both are exact
    ulps = np.abs(ts.view(np.int32).astype(np.int64)
                  - ks.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    same = (ulps == 0)[:, 0]
    np.testing.assert_array_equal(tq[same], kq[same])
    assert np.abs(tq[~same].astype(np.int32)
                  - kq[~same].astype(np.int32)).max(initial=0) <= 1


@pytest.mark.parametrize("n", [16384, 32668])
def test_flat_dequantize_vs_pallas_kernel_on_whole_grids(n):
    """64 and 128 rows: the row counts the Pallas dequantize covers."""
    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    tq, ts = tops.quantize_int8(_t(x))
    assert tq.shape[0] % 64 == 0
    want = np.asarray(jops.dequantize_int8(jnp.asarray(_n(tq)),
                                           jnp.asarray(_n(ts)), (n,)))
    np.testing.assert_array_equal(_n(tops.dequantize_int8(tq, ts, (n,))),
                                  want)


def test_flat_dequantize_takes_any_row_count():
    """The Pallas quantize pads its rows to a multiple of 64; the port's
    dequantize reads that layout and its own unpadded one alike, and
    writes every element."""
    n = 25617  # 101 rows; the Pallas kernel pads to 128
    x = np.random.default_rng(2).normal(size=(n,)).astype(np.float32)
    jq, js = jref.quantize_int8_ref(jnp.asarray(x))
    padded_q = np.zeros((128, 256), np.int8)
    padded_s = np.ones((128, 1), np.float32)
    padded_q[:101], padded_s[:101] = np.asarray(jq), np.asarray(js)
    want = np.asarray(jref.dequantize_int8_ref(jq, js, (n,)))
    for q, s in ((padded_q, padded_s), (np.asarray(jq), np.asarray(js))):
        got = _n(tops.dequantize_int8(_t(q), _t(s), (n,)))
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
