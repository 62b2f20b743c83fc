"""The CUDA wire kernels against their plain PyTorch versions, on a card.

Every test carries the ``cuda`` marker and skips without a card.  The file
imports neither JAX nor the reference, so it also runs on a machine that
has no JAX:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.config import HermesConfig, OptimizerConfig
from repro_torch.dist import wire
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.dequant_merge import (
    dequant_merge_cuda, dequant_merge_packed_cuda,
)
from repro_torch.kernels.loss_weighted_update import loss_weighted_update_cuda
from repro_torch.kernels.pack import pack_int4_cuda, unpack_int4_cuda
from repro_torch.kernels.quantize import (
    dequantize_int8_cuda, quantize_int8_cuda,
)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the wire kernels are CUDA only")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,axis", [
    ((256,), 0), ((3, 512, 5), 1), ((2, 7, 256), 2), ((1024, 3), 0),
    ((3, 2, 768, 3, 4), 2),
])
def test_pack_unpack_kernels_equal_plain(card, shape, axis):
    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.randint(-8, 8, shape, generator=gen, device=card,
                      dtype=torch.int8)
    p = pack_int4_cuda(q, axis=axis)
    assert torch.equal(p, ref.pack_nibbles_ref(q, axis=axis))
    assert torch.equal(unpack_int4_cuda(p, axis=axis), q)


def _scalars(card, n_pods, any_push, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    w2 = torch.rand(n_pods, generator=gen, device=card) + 0.2
    w2[0] = 0.0  # a closed pod
    w1 = torch.rand((), generator=gen, device=card) + 0.1
    return w1, w2, w1 + w2.sum(), torch.tensor(any_push, device=card)


@pytest.mark.parametrize("g_shape,n_pods", [
    ((4, 512), 2), ((3, 300), 3), ((2, 768, 5), 4), ((700,), 1), ((5, 64), 3),
])
@pytest.mark.parametrize("any_push", [True, False])
def test_dequant_merge_packed_kernel_bitwise(card, g_shape, n_pods, any_push):
    gen = torch.Generator(device=card).manual_seed(1)
    g = torch.randn(g_shape, generator=gen, device=card)
    delta = torch.randn((n_pods,) + g_shape, generator=gen, device=card)
    pay = wire.get_format("int4").encode(delta, key=(0, 0))
    ax = wire.block_axis((n_pods,) + g_shape)
    _, w2, denom, push = _scalars(card, n_pods, any_push, 2)
    got = dequant_merge_packed_cuda(g, pay["q_packed"], pay["scales"], w2,
                                    denom, push, axis=ax)
    want = ref.dequant_merge_packed_ref(g, pay["q_packed"], pay["scales"], w2,
                                        denom, push, axis=ax)
    assert torch.equal(got, want)


@pytest.mark.parametrize("g_shape,n_pods", [
    ((4, 512), 2), ((3, 300), 3), ((2, 768, 5), 4), ((700,), 1), ((5, 64), 3),
    ((512, 300), 3),
])
@pytest.mark.parametrize("any_push", [True, False])
def test_dequant_merge_kernel_bitwise(card, g_shape, n_pods, any_push):
    gen = torch.Generator(device=card).manual_seed(5)
    g = torch.randn(g_shape, generator=gen, device=card)
    delta = torch.randn((n_pods,) + g_shape, generator=gen, device=card)
    pay = wire.get_format("int8").encode(delta)
    ax = wire.block_axis((n_pods,) + g_shape)
    _, w2, denom, push = _scalars(card, n_pods, any_push, 6)
    got = dequant_merge_cuda(g, pay["q"], pay["scales"], w2, denom, push,
                             axis=ax)
    want = ref.dequant_merge_ref(g, pay["q"], pay["scales"], w2, denom, push,
                                 axis=ax)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 256, 1000, 25617, 70000])
@pytest.mark.parametrize("offset", [0, 1])
def test_quantize_dequantize_kernels_bitwise(card, n, offset):
    """``offset`` 1 starts both inputs off their vector alignment, so the
    kernels take their scalar loads."""
    gen = torch.Generator(device=card).manual_seed(n)
    x = torch.randn(n + offset, generator=gen, device=card)[offset:]
    x[: min(n, 256)] *= 1e-14  # a block whose scale floors at 1e-12
    q, s = quantize_int8_cuda(x)
    wq, ws = ref.quantize_int8_ref(x)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    buf = torch.empty(q.numel() + offset, dtype=torch.int8, device=card)
    qv = buf[offset:].view(q.shape)
    qv.copy_(q)
    got = dequantize_int8_cuda(qv, s, (n,))
    assert torch.equal(got, ref.dequantize_int8_ref(q, s, (n,)))


@pytest.mark.parametrize("shape,n_pods", [((4, 4096), 2), ((3, 1000), 3),
                                          ((17,), 4)])
@pytest.mark.parametrize("any_push", [True, False])
def test_loss_weighted_update_kernel_bitwise(card, shape, n_pods, any_push):
    gen = torch.Generator(device=card).manual_seed(3)
    g = torch.randn(shape, generator=gen, device=card)
    pods = torch.randn((n_pods,) + shape, generator=gen, device=card)
    w1, w2, denom, push = _scalars(card, n_pods, any_push, 4)
    got = loss_weighted_update_cuda(g, pods, w1, w2, denom, push)
    assert torch.equal(got, ref.loss_weighted_update_ref(g, pods, w1, w2,
                                                         denom, push))


def test_wrappers_check_inputs_and_count_launches(card):
    build.reset_launches()
    q = torch.zeros((2, 512), dtype=torch.int8, device=card)
    ops.unpack_int4(ops.pack_int4(q))
    assert build.LAUNCHES["pack_int4"] == 1
    assert build.LAUNCHES["unpack_int4"] == 1
    with pytest.raises(TypeError):
        pack_int4_cuda(q.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        pack_int4_cuda(torch.zeros((512, 2), dtype=torch.int8,
                                   device=card).T)
    with pytest.raises(ValueError, match="whole number"):
        pack_int4_cuda(torch.zeros((300,), dtype=torch.int8, device=card))
    assert build.LAUNCHES["pack_int4"] == 1
    x = torch.randn(1000, device=card)
    q, s = ops.quantize_int8(x)
    ops.dequantize_int8(q, s, x.shape)
    assert build.LAUNCHES["quantize_int8"] == 1
    assert build.LAUNCHES["dequantize_int8"] == 1
    with pytest.raises(ValueError, match="elements"):
        dequantize_int8_cuda(q, s, (5000,))
    with pytest.raises(TypeError):
        dequantize_int8_cuda(q.to(torch.int32), s, x.shape)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_int8_cuda(x.cpu())
    assert build.LAUNCHES["dequantize_int8"] == 1


def test_train_hermes_on_card_runs_every_kernel(card):
    from repro_torch.launch.train import _preset, train_hermes
    counts = {}
    for compression, async_rounds in (("int4", False), ("none", False),
                                      ("int8", True)):
        build.reset_launches()
        out = train_hermes(_preset("lmtiny"), steps=6, batch=2, seq=32,
                           pods=2, opt_cfg=OptimizerConfig(name="adamw",
                                                           lr=3e-3),
                           hcfg=HermesConfig(alpha=-0.8, lam=2,
                                             compression=compression,
                                             async_rounds=async_rounds),
                           log_every=10 ** 6)
        assert np.isfinite(out["global_loss"]) and out["merges"] >= 1
        assert out["dispatched"] == out["committed"] and out["drained"]
        counts[compression] = dict(build.LAUNCHES)
    assert counts["int8"]["dequant_merge"] > 0
    assert counts["int4"]["pack_int4"] > 0
    assert counts["int4"]["unpack_int4"] > 0
    assert counts["int4"]["dequant_merge_packed"] > 0
    assert counts["none"]["loss_weighted_update"] > 0
