"""The CUDA kernels (wire and serving) against their plain PyTorch
versions, on a card.

Every test carries the ``cuda`` marker and skips without a card.  The file
imports neither JAX nor the reference, so it also runs on a machine that
has no JAX:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import json
import math

import numpy as np
import pytest
import torch

from repro_torch.config import HermesConfig, OptimizerConfig
from repro_torch.dist import wire
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.dequant_merge import (
    dequant_merge_cuda, dequant_merge_group_cuda, dequant_merge_packed_cuda,
    dequant_merge_packed_group_cuda,
)
from repro_torch.kernels.flash_attention import (
    decode_combine, design, flash_attention_cuda, flash_attention_plain,
)
from repro_torch.kernels.loss_weighted_update import (
    loss_weighted_update_cuda, loss_weighted_update_group_cuda,
)
from repro_torch.kernels.pack import (
    pack_int4_cuda, pack_int4_group_cuda, pack_int4_group_plain,
    unpack_int4_cuda, unpack_int4_group_cuda, unpack_int4_group_plain,
)
from repro_torch.kernels.quantize import (
    dequantize_int8_cuda, quantize_int8_cuda,
)
from repro_torch.kernels.rglru_scan import rglru_cuda, rglru_plain
from repro_torch.kernels.rglru_scan import vector_path as rglru_vector_path
from repro_torch.kernels.rwkv6_scan import wkv6_cuda, wkv6_plain
from repro_torch.kernels.tile_copy import launch_spec as tile_copy_launch_spec
from repro_torch.kernels.tile_copy import tile_copy_cuda, tile_copy_plain

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA only")
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


# the grouped pack's leaf kinds, (nibble shape, axis, real elements d):
# row leaves, column leaves at inner 256 and 768, tail-only, odd tails,
# whole blocks and a tail (rows that break 16-byte slots: the scalar
# walk), a middle axis, lm100m's stacked wk
PACK_LEAVES = [
    ((3, 512), 1, 512), ((2, 512, 256), 1, 512), ((2, 256, 768), 1, 256),
    ((4, 12, 256), 2, 64), ((3, 256), 1, 77), ((5, 256), 1, 1),
    ((2, 512), 1, 300), ((2, 512, 3), 1, 300), ((3, 2, 768, 3, 4), 2, 768),
    ((768,), 0, 700), ((4, 12, 768, 4, 64), 2, 768),
]


def _nibble_leaves(card, specs, seed):
    """``(q, d, axis)`` leaves of int8 nibbles, zero past ``d`` (the
    quantizer's padding)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    leaves = []
    for shape, ax, d in specs:
        q = torch.randint(-8, 8, shape, generator=gen, device=card,
                          dtype=torch.int8)
        q.narrow(ax, d, shape[ax] - d).zero_()
        leaves.append((q, d, ax))
    return leaves


def _check_group(leaves):
    """One grouped pack and one grouped unpack of ``leaves``, each equal to
    its plain version bit for bit; returns the launches they made."""
    build.reset_launches()
    packed = pack_int4_group_cuda(leaves)
    wires = [(p, d, ax) for p, (_, d, ax) in zip(packed, leaves)]
    back = unpack_int4_group_cuda(wires)
    launches = (build.LAUNCHES["pack_int4"], build.LAUNCHES["unpack_int4"])
    for p, want in zip(packed, pack_int4_group_plain(leaves)):
        assert torch.equal(p, want), tuple(p.shape)
    for u, want, (q, d, ax) in zip(back, unpack_int4_group_plain(wires),
                                   leaves):
        assert torch.equal(u, want), tuple(u.shape)
        assert torch.equal(u, q.narrow(ax, 0, d))
    return launches


def test_grouped_pack_unpack_equal_plain_on_every_leaf_kind(card):
    assert _check_group(_nibble_leaves(card, PACK_LEAVES, 21)) == (1, 1)


def test_grouped_pack_unpack_exhaustive_over_byte_values(card):
    """Pack: every (low, high) nibble pair in a whole block and in a tail;
    unpack: every byte value in whole blocks and in a tail.  Each on the
    16-byte walk and, one byte off alignment, on the scalar walk."""
    lo, hi = torch.meshgrid(torch.arange(-8, 8), torch.arange(-8, 8),
                            indexing="ij")
    lo, hi = lo.reshape(-1), hi.reshape(-1)
    block = torch.cat([lo.reshape(2, 128), hi.reshape(2, 128)], dim=1)
    k = torch.arange(3 * 127).reshape(3, 127) % 256
    tail = torch.zeros((3, 256), dtype=torch.int64)
    tail[:, :127], tail[:, 127:254] = lo[k], hi[k]       # rem 254: 127 pairs
    byte = torch.arange(-128, 128).reshape(2, 128)
    for off in (0, 1):
        def at(t, off=off):
            t = t.to(device=card, dtype=torch.int8)
            buf = torch.zeros(t.numel() + off, dtype=torch.int8, device=card)
            v = buf[off:].view(t.shape)
            v.copy_(t)
            return v

        leaves = [(at(block), 256, 1), (at(tail), 254, 1)]
        packed = pack_int4_group_cuda(leaves)
        for p, want in zip(packed, pack_int4_group_plain(leaves)):
            assert torch.equal(p, want), off
        wires = [(at(byte), 256, 1), (at(byte), 255, 1),
                 (at(byte.reshape(-1)), 512, 0)]
        for u, want in zip(unpack_int4_group_cuda(wires),
                           unpack_int4_group_plain(wires)):
            assert torch.equal(u, want), off


def test_grouped_pack_unpack_take_misaligned_views(card):
    """Leaves one byte off their 16-byte alignment, and the pod rows
    ``a[i]`` of a pod-stacked wire array (``_merge_sliced``'s decode),
    take the kernels' scalar walk and stay bitwise."""
    leaves = []
    for q, d, ax in _nibble_leaves(card, PACK_LEAVES, 22):
        buf = torch.empty(q.numel() + 1, dtype=torch.int8, device=card)
        v = buf[1:].view(q.shape)
        v.copy_(q)
        leaves.append((v, d, ax))
    assert _check_group(leaves) == (1, 1)
    stacked, = _nibble_leaves(card, [((3, 2, 512), 2, 300)], 23)
    wire_rows, = pack_int4_group_cuda([stacked])
    rows = [(wire_rows[i], 300, 1) for i in range(3)]   # 300-byte strides
    for u, want in zip(unpack_int4_group_cuda(rows),
                       unpack_int4_group_plain(rows)):
        assert torch.equal(u, want)


def test_grouped_pack_splits_long_trees_and_checks_inputs(card):
    """33 leaves take two launches each way; bad leaves raise before any
    launch."""
    specs = [((2 + i % 3, 512), 1, 1 + 15 * i) for i in range(33)]
    assert _check_group(_nibble_leaves(card, specs, 24)) == (2, 2)
    q, d, ax = _nibble_leaves(card, [((2, 512), 1, 300)], 25)[0]
    build.reset_launches()
    with pytest.raises(TypeError):
        pack_int4_group_cuda([(q.to(torch.int32), d, ax)])
    with pytest.raises(ValueError, match="CUDA"):
        pack_int4_group_cuda([(q, d, ax), (q.cpu(), d, ax)])
    with pytest.raises(ValueError, match="contiguous"):
        pack_int4_group_cuda([(q.T, 2, 0)])
    with pytest.raises(ValueError, match="real elements"):
        pack_int4_group_cuda([(q, 513, ax)])
    p, = pack_int4_group_cuda([(q, d, ax)])
    with pytest.raises(ValueError, match="wire bytes"):
        unpack_int4_group_cuda([(p, d + 3, ax)])
    assert build.LAUNCHES["pack_int4"] == 1
    assert build.LAUNCHES["unpack_int4"] == 0


def test_encode_tree_packs_and_unpacks_once_on_card(card):
    """``encode_tree(..., "int4")`` with a residual is one pack and one
    unpack launch on the card, and its payloads and residuals are the
    per-leaf plain composition's bitwise."""
    from repro_torch.dist.compression import encode_tree
    gen = torch.Generator(device=card).manual_seed(26)
    shapes = [(3, 512), (3, 2, 70), (4, 12, 64), (2, 300, 3), (3, 768, 4),
              ()]
    tree = {f"l{i}": torch.randn(s, generator=gen, device=card)
            for i, s in enumerate(shapes)}
    noise = wire.GeneratorNoise(3, card)
    build.reset_launches()
    pays, rec, err = encode_tree(tree, "int4", round_step=2, noise=noise)
    assert build.LAUNCHES["pack_int4"] == 1
    assert build.LAUNCHES["unpack_int4"] == 1
    fmt = wire.get_format("int4")
    for i, (k, x) in enumerate(tree.items()):
        q, scale, s, ax, d, _ = fmt._quantize(x, (2, i), noise)
        packed, = pack_int4_group_plain([(q, d, ax)])
        assert torch.equal(pays[k]["q_packed"], packed), k
        assert torch.equal(pays[k]["scales"], scale), k
        qt, = unpack_int4_group_plain([(packed, d, ax)])
        r = wire.BlockedIntFormat.decode(fmt, {"q": qt, "scales": scale},
                                         x.shape, x.dtype)
        assert torch.equal(rec[k], r) and torch.equal(err[k], x - r), k


def _scalars(card, n_pods, any_push, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    w2 = torch.rand(n_pods, generator=gen, device=card) + 0.2
    w2[0] = 0.0  # a closed pod
    w1 = torch.rand((), generator=gen, device=card) + 0.1
    return w1, w2, w1 + w2.sum(), torch.tensor(any_push, device=card)


# the merges' layouts: row tiles (blocked on the last axis) whole and with
# a tail, column tiles (a middle blocked axis) at lm100m's wq (inner 768)
# and with an inner extent that is not a multiple of 4, int8 pod strides
# that are not multiples of 4 or 16 ((3, 301): 903 bytes), 8 pods
MERGE_CASES = [
    ((4, 512), 2), ((3, 300), 3), ((2, 768, 5), 4), ((700,), 1), ((5, 64), 3),
    ((2, 768, 12, 64), 4), ((2, 512, 3), 3), ((3, 301), 2), ((6, 1024), 8),
]


@pytest.mark.parametrize("g_shape,n_pods", MERGE_CASES)
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
    # the canonical payload (the tail re-paired into a whole block) too
    canon = ref.canonicalize_packed_ref(pay["q_packed"], g.shape[ax - 1],
                                        axis=ax).contiguous()
    assert torch.equal(dequant_merge_packed_cuda(
        g, canon, pay["scales"], w2, denom, push, axis=ax), want)


@pytest.mark.parametrize("g_shape,n_pods", MERGE_CASES + [((512, 300), 3)])
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


@pytest.mark.parametrize("g_shape,n_pods", [((4, 512), 2), ((2, 768, 5), 3),
                                            ((2, 256, 8), 4)])
def test_merge_kernels_take_unaligned_views(card, g_shape, n_pods):
    """``g`` and the payloads start one element off their vector
    alignment, so the kernels take their scalar path."""
    gen = torch.Generator(device=card).manual_seed(9)
    n = math.prod(g_shape)
    g = torch.randn(n + 1, generator=gen, device=card)[1:].view(g_shape)
    delta = torch.randn((n_pods,) + g_shape, generator=gen, device=card)
    ax = wire.block_axis((n_pods,) + g_shape)
    _, w2, denom, push = _scalars(card, n_pods, True, 10)
    for name, kern, plain in (
            ("int8", dequant_merge_cuda, ref.dequant_merge_ref),
            ("int4", dequant_merge_packed_cuda,
             ref.dequant_merge_packed_ref)):
        pay = wire.get_format(name).encode(delta, key=(0, 0))
        q = pay["q" if name == "int8" else "q_packed"]
        buf = torch.empty(q.numel() + 1, dtype=torch.int8, device=card)
        qv = buf[1:].view(q.shape)
        qv.copy_(q)
        got = kern(g, qv, pay["scales"], w2, denom, push, axis=ax)
        assert torch.equal(got, plain(g, q, pay["scales"], w2, denom, push,
                                      axis=ax)), name


@pytest.mark.parametrize("any_push", [True, False])
def test_grouped_merge_equals_plain_per_leaf(card, any_push):
    """One grouped call over a mixed tree (row tiles whole and with tails,
    column tiles, an unaligned inner extent) is one launch per format and
    equals the per-leaf plain versions bitwise."""
    shapes = [(4, 512), (2, 512, 3), (3, 300), (12, 64), (2, 768, 4, 64),
              (700,), (3, 301), (768,)]
    n_pods = 4
    gen = torch.Generator(device=card).manual_seed(11)
    gs = [torch.randn(s, generator=gen, device=card) for s in shapes]
    _, w2, denom, push = _scalars(card, n_pods, any_push, 12)
    for name, group, plain in (
            ("int8", dequant_merge_group_cuda, ref.dequant_merge_ref),
            ("int4", dequant_merge_packed_group_cuda,
             ref.dequant_merge_packed_ref)):
        fmt = wire.get_format(name)
        leaves = []
        for i, g in enumerate(gs):
            pay = fmt.encode(torch.randn((n_pods,) + g.shape, generator=gen,
                                         device=card), key=(0, i))
            leaves.append((g, pay["q" if name == "int8" else "q_packed"],
                           pay["scales"],
                           wire.block_axis((n_pods,) + g.shape)))
        build.reset_launches()
        got = group(leaves, w2, denom, push)
        launches = dict(build.LAUNCHES)
        kernel = "dequant_merge" if name == "int8" else "dequant_merge_packed"
        assert launches[kernel] == 1, launches
        for (g, q, sc, ax), out in zip(leaves, got):
            assert torch.equal(out, plain(g, q, sc, w2, denom, push,
                                          axis=ax)), (name, tuple(g.shape))


def test_grouped_merge_splits_long_trees_and_checks_inputs(card):
    """A tree of more leaves than a launch's parameters carry takes one
    launch per ``GROUP_LEAVES``; mixed devices and pod counts raise."""
    from repro_torch.kernels.dequant_merge import GROUP_LEAVES
    n_pods, n = 2, GROUP_LEAVES + 5
    gen = torch.Generator(device=card).manual_seed(13)
    fmt = wire.get_format("int8")
    leaves = []
    for i in range(n):
        g = torch.randn((3, 256 + i), generator=gen, device=card)
        pay = fmt.encode(torch.randn((n_pods,) + g.shape, generator=gen,
                                     device=card))
        leaves.append((g, pay["q"], pay["scales"], 2))
    _, w2, denom, push = _scalars(card, n_pods, True, 14)
    build.reset_launches()
    got = dequant_merge_group_cuda(leaves, w2, denom, push)
    assert build.LAUNCHES["dequant_merge"] == 2
    for (g, q, sc, ax), out in zip(leaves, got):
        assert torch.equal(out, ref.dequant_merge_ref(g, q, sc, w2, denom,
                                                      push, axis=ax))
    g, q, sc, ax = leaves[0]
    with pytest.raises(ValueError, match="one card"):
        dequant_merge_group_cuda([(g, q.cpu(), sc, ax)], w2, denom, push)
    with pytest.raises(ValueError, match="pods"):
        dequant_merge_group_cuda([leaves[0], (g, q[:1], sc[:1], ax)], w2,
                                 denom, push)
    with pytest.raises(ValueError, match="pod axis"):
        dequant_merge_group_cuda([(g, q, sc, 0)], w2, denom, push)
    assert build.LAUNCHES["dequant_merge"] == 2


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


# the grouped update's leaves: whole 16-byte slots in every dtype, odd
# lengths (the scalar path), a 1-element leaf, lm100m's wq layout
LWU_SHAPES = [(4, 4096), (3, 1000), (17,), (1,), (2, 768, 12, 64), (7, 130),
              (4096,), (5, 3)]


def _lwu_leaves(card, shapes, n_pods, dtypes, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    leaves = []
    for s, dt in zip(shapes, dtypes):
        g = torch.randn(s, generator=gen, device=card)
        pods = g[None] + 1e-2 * torch.randn((n_pods,) + s, generator=gen,
                                            device=card)
        leaves.append((g.to(dt), pods.to(dt)))
    return leaves


def _lwu_check(leaves, got, w1, w2, denom, push):
    for (g, pods), out in zip(leaves, got):
        assert out.dtype == g.dtype and out.shape == g.shape
        assert torch.equal(out, ref.loss_weighted_update_ref(
            g, pods, w1, w2, denom, push)), (tuple(g.shape), g.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("any_push", [True, False])
def test_loss_weighted_update_group_bitwise(card, dtype, any_push):
    """Every leaf of a tree in one launch, bitwise the plain version: 16-byte
    slots where a leaf is whole slots, element by element where it is not,
    and g's bytes when no pod pushes."""
    n_pods = 3
    w1, w2, denom, push = _scalars(card, n_pods, any_push, 29)
    leaves = _lwu_leaves(card, LWU_SHAPES, n_pods,
                         [dtype] * len(LWU_SHAPES), 8)
    build.reset_launches()
    got = loss_weighted_update_group_cuda(leaves, w1, w2, denom, push)
    assert build.LAUNCHES["loss_weighted_update"] == 1
    _lwu_check(leaves, got, w1, w2, denom, push)
    if not any_push:
        assert all(torch.equal(o, g) for o, (g, _) in zip(got, leaves))
    # a view one element off 16-byte alignment: the scalar path
    g, pods = leaves[0]
    buf = torch.empty(g.numel() + 1, dtype=dtype, device=card)
    gv = buf[1:].view(g.shape)
    gv.copy_(g)
    out, = loss_weighted_update_group_cuda([(gv, pods)], w1, w2, denom, push)
    assert torch.equal(out, ref.loss_weighted_update_ref(g, pods, w1, w2,
                                                         denom, push))


def test_loss_weighted_update_group_launches_a_dtype_and_32_leaves(card):
    """A tree of mixed dtypes takes one launch a dtype; 33 leaves of one
    dtype take two (32 descriptors a launch); 8 pods load in two chunks."""
    n_pods = 8
    w1, w2, denom, push = _scalars(card, n_pods, True, 30)
    dts = [torch.float32, torch.bfloat16, torch.float16]
    mixed = _lwu_leaves(card, LWU_SHAPES, n_pods,
                        [dts[i % 3] for i in range(len(LWU_SHAPES))], 9)
    build.reset_launches()
    got = loss_weighted_update_group_cuda(mixed, w1, w2, denom, push)
    assert build.LAUNCHES["loss_weighted_update"] == 3
    _lwu_check(mixed, got, w1, w2, denom, push)
    many = _lwu_leaves(card, [(s,) for s in range(1, 34)], 2,
                       [torch.bfloat16] * 33, 10)
    w1, w2, denom, push = _scalars(card, 2, True, 31)
    build.reset_launches()
    got = loss_weighted_update_group_cuda(many, w1, w2, denom, push)
    assert build.LAUNCHES["loss_weighted_update"] == 2
    _lwu_check(many, got, w1, w2, denom, push)
    with pytest.raises(ValueError, match="pods"):
        loss_weighted_update_group_cuda([many[0], mixed[1]], w1, w2, denom,
                                        push)
    assert build.LAUNCHES["loss_weighted_update"] == 2


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("any_push", [True, False])
def test_merges_take_half_precision_leaves(card, dtype, any_push):
    """The three merges on bf16 and fp16 leaves (row tiles, column tiles,
    tails, the scalar path), bitwise their plain versions: widened on
    load, merged in fp32, rounded once on store.  A grouped merge over
    leaves of two dtypes takes one launch a dtype."""
    shapes = [(4, 512), (2, 768, 12, 64), (3, 300), (2, 512, 3), (700,)]
    n_pods = 3
    gen = torch.Generator(device=card).manual_seed(31)
    w1, w2, denom, push = _scalars(card, n_pods, any_push, 32)
    for name, group, plain in (
            ("int8", dequant_merge_group_cuda, ref.dequant_merge_ref),
            ("int4", dequant_merge_packed_group_cuda,
             ref.dequant_merge_packed_ref)):
        fmt = wire.get_format(name)
        leaves = []
        for i, s in enumerate(shapes):
            g = torch.randn(s, generator=gen, device=card)
            pay = fmt.encode(1e-2 * torch.randn((n_pods,) + s, generator=gen,
                                                device=card), key=(0, i))
            leaves.append((g.to(dtype) if i else g,
                           pay["q" if name == "int8" else "q_packed"],
                           pay["scales"], wire.block_axis((n_pods,) + s)))
        build.reset_launches()
        got = group(leaves, w2, denom, push)
        kernel = "dequant_merge" if name == "int8" else "dequant_merge_packed"
        assert build.LAUNCHES[kernel] == 2   # one fp32 leaf, four of dtype
        for (g, q, sc, ax), out in zip(leaves, got):
            assert out.dtype == g.dtype
            assert torch.equal(out, plain(g, q, sc, w2, denom, push,
                                          axis=ax)), (name, tuple(g.shape))
        # one element off the 8-byte alignment: the scalar path
        g, q, sc, ax = leaves[1]
        buf = torch.empty(g.numel() + 1, dtype=dtype, device=card)
        gv = buf[1:].view(g.shape)
        gv.copy_(g)
        out, = group([(gv, q, sc, ax)], w2, denom, push)
        assert torch.equal(out, plain(g, q, sc, w2, denom, push, axis=ax))
    for shape in ((4, 4096), (17,), (3, 1000)):
        g = torch.randn(shape, generator=gen, device=card).to(dtype)
        pods = (g[None] + 1e-2 * torch.randn((n_pods,) + shape, generator=gen,
                                             device=card)).to(dtype)
        got = loss_weighted_update_cuda(g, pods, w1, w2, denom, push)
        assert got.dtype == dtype
        assert torch.equal(got, ref.loss_weighted_update_ref(
            g, pods, w1, w2, denom, push)), shape
    with pytest.raises(TypeError, match="dtype"):
        loss_weighted_update_cuda(g.float(), pods, w1, w2, denom, push)
    with pytest.raises(TypeError):
        dequant_merge_cuda(g.double(), *leaves[0][1:3], w2, denom, push)


@pytest.mark.parametrize("compression", ["none", "fp16", "int8", "int4"])
def test_bf16_hermes_round_on_card_equals_plain(card, compression,
                                                monkeypatch):
    """A bf16 tree's Hermes round through the merge kernels, in every
    wire format, bitwise the same round with the merges' plain versions
    on the same inputs (the reference's kernels take any float leaf; the
    port's raised on a bf16 ``g`` before its kernels were templated on
    the leaf dtype)."""
    from repro_torch.dist import hermes_sync as hs
    from repro_torch.core.gup import gup_gate
    from repro_torch.kernels import dequant_merge as dqm
    from repro_torch.kernels import loss_weighted_update as lwu
    from repro_torch.utils.trees import tree_leaves, tree_map
    n = 3
    w, pods = _lmtiny_pods(card, n, 7)
    w = tree_map(lambda x: x.to(torch.bfloat16), w)
    pods = tree_map(lambda x: x.to(torch.bfloat16), pods)
    cfg = HermesConfig(compression=compression,
                       error_feedback=compression in ("int8", "int4"))
    gup = hs.hermes_pod_state(cfg, n, card)
    for level in (3.0, 3.2):
        _, gup = gup_gate(gup, torch.full((n,), level, device=card), cfg)
    losses = torch.tensor([2.1, 2.2, 2.0], device=card)
    L = torch.tensor(3.4, device=card)

    def run():
        return hs.hermes_round(pods, gup, losses, w, L, cfg, use_kernel=True,
                               round_step=1,
                               noise=wire.GeneratorNoise(6, card))

    build.reset_launches()
    got = run()
    launches = dict(build.LAUNCHES)
    kernel = {"none": "loss_weighted_update", "fp16": "loss_weighted_update",
              "int8": "dequant_merge",
              "int4": "dequant_merge_packed"}[compression]
    assert got["merged"] and launches[kernel] > 0, launches
    monkeypatch.setattr(ops, "dequant_merge_group",
                        dqm.dequant_merge_group_plain)
    monkeypatch.setattr(ops, "dequant_merge_packed_group",
                        dqm.dequant_merge_packed_group_plain)
    monkeypatch.setattr(ops, "loss_weighted_update",
                        lwu.loss_weighted_update_plain)
    monkeypatch.setattr(ops, "loss_weighted_update_group",
                        lwu.loss_weighted_update_group_plain)
    build.reset_launches()
    want = run()
    assert build.LAUNCHES[kernel] == 0
    for a, b in zip(tree_leaves([got["w_global"], got["pod_params"]]),
                    tree_leaves([want["w_global"], want["pod_params"]])):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


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


def _lmtiny_pods(card, n_pods, seed):
    from repro_torch.launch.train import _preset
    from repro_torch.models.lm import init_lm
    from repro_torch.utils.trees import tree_map
    w = init_lm(_preset("lmtiny"), seed, card)
    gen = torch.Generator(device=card).manual_seed(seed + 1)
    pods = tree_map(lambda g: g[None] + 1e-2 * torch.randn(
        (n_pods,) + tuple(g.shape), generator=gen, device=card), w)
    return w, pods


def test_cluster_partial_pack_unpack_kernels_equal_plain(card):
    """The slow tier's re-encode packs the ``(n_clusters,) + leaf`` partial
    tree: one grouped pack and one unpack launch for it, bitwise the
    plain versions."""
    from repro_torch.utils.trees import tree_leaves
    w, pods = _lmtiny_pods(card, 2, 3)
    fmt = wire.get_format("int4")
    noise = wire.GeneratorNoise(4, card).fold(0x5C1)
    leaves = []
    for i, x in enumerate(tree_leaves(pods)):
        q, _, _, ax, d, _ = fmt._quantize(1e-2 * x, (0, i), noise)
        leaves.append((q, d, ax))
    build.reset_launches()
    packed = pack_int4_group_cuda(leaves)
    assert build.LAUNCHES["pack_int4"] == 1
    assert all(torch.equal(a, b) for a, b in
               zip(packed, pack_int4_group_plain(leaves)))
    wires = [(p, d, ax) for p, (_, d, ax) in zip(packed, leaves)]
    got = unpack_int4_group_cuda(wires)
    assert build.LAUNCHES["unpack_int4"] == 1
    assert all(torch.equal(a, b) for a, b in
               zip(got, unpack_int4_group_plain(wires)))
    assert all(torch.equal(a, q.narrow(ax, 0, d))
               for a, (q, d, ax) in zip(got, leaves))


@pytest.mark.parametrize("mode", ["none", "fp16", "int8", "int4"])
def test_two_tier_round_pins_on_card(card, mode):
    """The two-tier round's own pins on the card, bitwise: one cluster is
    ``hermes_round``; the sync round is dispatch + commit; a commit whose
    ``live`` mask kills a gated member drops its whole cluster, as a
    round with that cluster shut."""
    from repro_torch.core.gup import gup_gate
    from repro_torch.dist import hermes_sync as hs
    from repro_torch.utils.trees import tree_leaves
    n = 4
    w, pods = _lmtiny_pods(card, n, 5)
    cfgs = {c: HermesConfig(compression=mode, n_clusters=c,
                            error_feedback=mode in ("int8", "int4"))
            for c in (1, 2)}
    gup = hs.hermes_pod_state(cfgs[2], n, card)
    for level in (3.0, 3.2):  # a loss history the next losses beat
        _, gup = gup_gate(gup, torch.full((n,), level, device=card),
                          cfgs[2])
    losses = torch.tensor([2.1, 2.2, 2.0, 2.3], device=card)
    L = torch.tensor(3.4, device=card)
    kw = dict(round_step=1, noise=wire.GeneratorNoise(6, card))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(a), tree_leaves(b)))

    build.reset_launches()
    one = hs.hermes_cluster_round(pods, gup, losses, w, L, cfgs[1], **kw)
    flat = hs.hermes_round(pods, gup, losses, w, L, cfgs[1], **kw)
    assert same([one["w_global"], one["pod_params"]],
                [flat["w_global"], flat["pod_params"]])
    sync = hs.hermes_cluster_round(pods, gup, losses, w, L, cfgs[2], **kw)
    assert bool(sync["gates"].all()) and sync["merged"]
    dp = hs.hermes_cluster_dispatch(pods, gup, losses, w, L, cfgs[2], **kw)
    cm = hs.hermes_cluster_commit(pods, dp["pending"], w, cfg=cfgs[2])
    assert same([sync["w_global"], sync["pod_params"]],
                [cm["w_global"], cm["pod_params"]])
    dead = hs.hermes_cluster_commit(
        pods, dp["pending"], w, cfg=cfgs[2],
        live=torch.tensor([True, True, True, False], device=card))
    shut = hs.hermes_cluster_round(
        pods, gup, losses, w, L, cfgs[2],
        live=torch.tensor([True, True, False, False], device=card), **kw)
    assert same([dead["w_global"], dead["pod_params"]],
                [shut["w_global"], shut["pod_params"]])
    if mode == "int4":
        assert build.LAUNCHES["pack_int4"] > 0
        assert build.LAUNCHES["unpack_int4"] > 0


def _attention_inputs(card, B, Sq, Skv, H, K, D, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    q, k, v = (torch.randn((B, S, n, D), generator=gen, device=card)
               .to(dtype) for S, n in ((Sq, H), (Skv, K), (Skv, K)))
    return q, k, v


# (B, Sq, Skv, H, K, D, causal, window, q_start, written): queries at
# positions q_start.., cache slots 0..written-1 at positions 0.. and the
# rest unwritten (-1); written=None means a full contiguous KV, and
# "ring" a wrapped ring buffer of Skv slots, slot s holding the latest
# position <= q_start that is s modulo Skv (out of order, as a local-
# attention cache holds them after decode at q_start).
ATTENTION_CASES = [
    (2, 37, 37, 6, 2, 64, True, 0, 0, None),      # G=3, ragged tiles
    (2, 37, 37, 6, 2, 64, False, 0, 0, None),
    (1, 100, 100, 4, 4, 32, True, 16, 0, None),   # sliding window
    (3, 1, 90, 6, 2, 64, True, 0, 70, 71),        # decode at position 70
    (2, 1, 90, 6, 2, 16, True, 16, 70, 71),       # windowed decode
    (1, 20, 77, 4, 1, 128, True, 0, 0, 20),       # prefill into a cache
    # recurrentgemma-2b's attention: MQA (K 1, G 10), head dim 256
    (2, 150, 150, 10, 1, 256, True, 64, 0, None),  # windowed prefill
    (2, 1, 96, 10, 1, 256, True, 96, 200, "ring"),  # decode on the ring
    # split-KV decode: Sq 1 and 16 across split boundaries (Skv 577 leaves
    # a ragged last split), splits with every slot unwritten, G 10 at D 256
    # on the 2048-slot ring
    (8, 1, 577, 12, 4, 64, True, 0, 512, 513),
    (2, 16, 300, 6, 2, 64, True, 0, 200, 216),    # 16 rows a head
    (1, 16, 200, 10, 1, 32, True, 24, 100, 116),  # 160 rows: 10 groups
    (2, 1, 1024, 6, 2, 128, True, 0, 40, 41),     # most splits unwritten
    (4, 1, 2048, 10, 1, 256, True, 2048, 2560, "ring"),
    (2, 1, 2048, 6, 6, 16, True, 0, 2047, None),  # G 1
    # wgmma bf16 prefill (fp32 takes the SIMT kernel): ragged Sq, windows
    (2, 37, 37, 4, 2, 64, True, 0, 0, None),
    (1, 150, 150, 6, 2, 128, True, 0, 0, None),
    (2, 150, 150, 10, 1, 256, True, 48, 0, None),
    (1, 150, 200, 4, 1, 64, True, 100, 0, 150),   # into a longer cache
    (2, 37, 37, 4, 2, 128, False, 0, 0, None),
    # the encoder-decoder (seamless-m4t-large-v2, D 64, 16 heads on 16):
    # the encoder's non-causal prefill at a ragged Sq, the cross-attention
    # of a decoder prefill over the encoder's keys, and the cross decode,
    # Sq 1 and 16, over 1024 encoder keys (every split runs)
    (2, 150, 150, 16, 16, 64, False, 0, 0, None),
    (2, 37, 150, 16, 16, 64, False, 0, 0, None),
    (4, 1, 1024, 16, 16, 64, False, 0, 0, None),
    (2, 16, 1024, 16, 16, 64, False, 0, 5, None),
    # llava-next-34b's GQA, G 7 at D 128: prefill, and decode into a cache
    # with unwritten slots past the query
    (1, 150, 150, 14, 2, 128, True, 0, 0, None),
    (2, 1, 700, 14, 2, 128, True, 0, 600, 601),
]


@pytest.mark.parametrize("case", ATTENTION_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(card, case, dtype):
    B, Sq, Skv, H, K, D, causal, window, q_start, written = case
    q, k, v = _attention_inputs(card, B, Sq, Skv, H, K, D, dtype, 5)
    qpos = torch.arange(q_start, q_start + Sq, dtype=torch.int32,
                        device=card)
    kvpos = torch.arange(Skv, dtype=torch.int32, device=card)
    if written == "ring":
        kvpos = q_start - (q_start - kvpos) % Skv
    elif written is not None:
        kvpos[written:] = -1
    kw = dict(causal=causal, window=window)
    build.reset_launches()
    got = flash_attention_cuda(q, k, v, qpos, kvpos, **kw)
    want = flash_attention_plain(q, k, v, qpos, kvpos, **kw)
    assert got.dtype == dtype and got.shape == (B, Sq, H, D)
    # fp32: sums over <= 2048 keys in another order, a few rescalings per
    # tile; bf16: both round one fp32 result, so one bf16 ulp (at most 2^-7
    # of the value) apart
    tol = 2e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    assert build.LAUNCHES[design(Sq, D, dtype)] >= 1


# MLA's head dims, v narrower than q and k: (B, Sq, Skv, H, K, D, Dv,
# q_start, written), causal, with the scale MLA passes, (nope + rope)^-0.5
# = D^-0.5.  deepseek-v2-lite's (192, 128): decode at Sq 1 and 16 on its
# 1057-slot serving cache, prefill with ragged tiles and into a longer
# cache; its smoke config's (24, 16): decode and prefill.
MLA_CASES = [
    (4, 1, 1057, 16, 16, 192, 128, 1024, 1025),
    (2, 16, 1057, 16, 16, 192, 128, 1000, 1016),
    (2, 150, 150, 4, 4, 192, 128, 0, None),
    (1, 100, 160, 2, 2, 192, 128, 0, 100),
    (2, 1, 40, 4, 4, 24, 16, 30, 31),
    (2, 37, 37, 4, 4, 24, 16, 0, None),
    (1, 16, 70, 4, 2, 24, 16, 40, 56),
]


@pytest.mark.parametrize("case", MLA_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mla_dims_match_plain(card, case, dtype):
    B, Sq, Skv, H, K, D, Dv, q_start, written = case
    gen = torch.Generator(device=card).manual_seed(11)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for shape in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, Dv)))
    qpos = torch.arange(q_start, q_start + Sq, dtype=torch.int32,
                        device=card)
    kvpos = torch.arange(Skv, dtype=torch.int32, device=card)
    if written is not None:
        kvpos[written:] = -1
    kw = dict(causal=True, scale=D ** -0.5)
    build.reset_launches()
    got = flash_attention_cuda(q, k, v, qpos, kvpos, **kw)
    want = flash_attention_plain(q, k, v, qpos, kvpos, **kw)
    assert got.dtype == dtype and got.shape == (B, Sq, H, Dv)
    # as test_flash_attention_kernel_matches_plain: fp32 sums in another
    # order; bf16 one rounding of one fp32 result, one bf16 ulp apart
    tol = 2e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    kind = design(Sq, D, dtype, Dv)
    assert build.LAUNCHES[kind] == 1
    if kind == "flash_decode":
        assert build.LAUNCHES["flash_decode_combine"] == 1


# fp32 prefill on scores in the thousands, as recurrentgemma-2b's random
# init gives (q, k ~ N(0, 45^2): q.k / sqrt(D) ~ N(0, 2025^2)).  Near ties
# between two keys make the output follow a score's last bits, so the
# kernel holds the plain version to 1e-5 of the largest output only if each
# q.k is one FMA chain over d in order, as cuBLAS's fp32 GEMM computes the
# plain path's scores: the same kernel with the four FMAs of each 16-byte
# load in the order d + 3 .. d reads ~1e-4.
@pytest.mark.parametrize("dims", [(64, 64), (192, 128), (256, 256)])
@pytest.mark.parametrize("window", [0, 128])
def test_flash_simt_large_scores_match_plain(card, dims, window):
    D, Dv = dims
    B, S, H, K = 1, 300, 4, 2
    gen = torch.Generator(device=card).manual_seed(19)
    q, k = (45 * torch.randn(shape, generator=gen, device=card)
            for shape in ((B, S, H, D), (B, S, K, D)))
    v = torch.randn((B, S, K, Dv), generator=gen, device=card)
    pos = torch.arange(S, dtype=torch.int32, device=card)
    kw = dict(causal=True, window=window)
    build.reset_launches()
    got = flash_attention_cuda(q, k, v, pos, pos, **kw)
    want = flash_attention_plain(q, k, v, pos, pos, **kw)
    assert build.LAUNCHES["flash_simt"] == 1
    gap = float((got - want).abs().max()) / float(want.abs().max())
    assert gap <= 1e-5, gap


# rwkv6-3b decode (4, 1, 40, 64) and a full prefill head count at short T
# (1, 256, 40, 64); T that are not multiples of the 16-step ring slot (37,
# 70, 33, 50); decode and prefill at D 16 (a cluster of one) and D 128 (a
# cluster of eight)
@pytest.mark.parametrize("B,T,H,D", [(2, 1, 3, 64), (1, 37, 2, 64),
                                     (2, 70, 2, 32), (1, 5, 1, 16),
                                     (1, 9, 2, 128), (4, 1, 40, 64),
                                     (1, 256, 40, 64), (1, 33, 2, 16),
                                     (2, 1, 2, 16), (2, 50, 3, 128),
                                     (1, 1, 2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_matches_plain(card, B, T, H, D, dtype):
    gen = torch.Generator(device=card).manual_seed(6)
    r, k, v = (torch.randn((B, T, H, D), generator=gen, device=card)
               .to(dtype) for _ in range(3))
    # the model's decay regime: log_w = -exp(~0) ~ -1 per step
    log_w = -torch.exp(0.3 * torch.randn((B, T, H, D), generator=gen,
                                         device=card))
    u = 0.5 * torch.randn((H, D), generator=gen, device=card)
    s0 = torch.randn((B, H, D, D), generator=gen, device=card)
    y, s = wkv6_cuda(r, k, v, log_w, u, s0)
    y_ref, s_ref = wkv6_plain(r, k, v, log_w, u, s0)
    assert y.dtype == dtype and s.dtype == torch.float32
    # fp32 sums over D keys in another order: 1e-5 of the largest value;
    # bf16 y: one bf16 ulp (at most 2^-7 of the value) on top
    scale = float(y_ref.float().abs().max())
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=rtol,
                               atol=1e-5 * scale)
    torch.testing.assert_close(s, s_ref, rtol=1e-5,
                               atol=1e-5 * float(s_ref.abs().max()))


# T not a multiple of the 32-step ring slot ((1, 33, 2560), (1, 2561,
# 64)); W % 4 != 0 takes the scalar path ((2, 70, 30), (3, 40, 7))
@pytest.mark.parametrize("B,T,W", [(2, 45, 24), (1, 128, 64), (3, 1, 100),
                                   (2, 300, 2560), (4, 1, 2560),
                                   (1, 33, 2560), (1, 2561, 64),
                                   (2, 70, 30), (3, 40, 7)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_kernel_equals_plain_bitwise(card, B, T, W, with_h0):
    """Ragged B, T and W (T 1 is decode): the kernel's fp32 multiply then
    add, never an FMA, equals the plain version's two torch ops."""
    gen = torch.Generator(device=card).manual_seed(T * W)
    a = torch.sigmoid(torch.randn((B, T, W), generator=gen, device=card)) \
        * 0.3 + 0.7
    b = 0.2 * torch.randn((B, T, W), generator=gen, device=card)
    h0 = 0.5 * torch.randn((B, W), generator=gen, device=card) if with_h0 \
        else None
    y, hT = rglru_cuda(a, b, h0)
    y_ref, hT_ref = rglru_plain(a, b, h0)
    assert y.dtype == hT.dtype == torch.float32
    assert torch.equal(y, y_ref) and torch.equal(hT, hT_ref)


@pytest.mark.parametrize("T", [1, 70])
def test_scan_kernels_take_unaligned_views(card, T):
    """Views that start 4 bytes past a 16-byte boundary: the RG-LRU takes
    its scalar path, WKV6 copies them; both still match the plain
    versions."""
    gen = torch.Generator(device=card).manual_seed(T)
    buf = torch.rand((2 * 2 * T * 64 + 1,), generator=gen, device=card)
    a = buf[1:].reshape(2, 2, T, 64)
    assert not rglru_vector_path(64, a[0], a[1])
    h0 = torch.randn((2, 64), generator=gen, device=card)
    y, hT = rglru_cuda(a[0], a[1], h0)
    y_ref, hT_ref = rglru_plain(a[0], a[1], h0)
    assert torch.equal(y, y_ref) and torch.equal(hT, hT_ref)
    B, H, D = 1, 2, 32
    big = torch.randn((4 * B * T * H * D + 1,), generator=gen, device=card)
    r, k, v, w = big[1:].reshape(4, B, T, H, D)
    log_w = -torch.exp(0.3 * w)
    u = 0.5 * torch.randn((H, D), generator=gen, device=card)
    s0 = torch.randn((B, H, D, D), generator=gen, device=card)
    y, s = wkv6_cuda(r, k, v, log_w, u, s0)
    y_ref, s_ref = wkv6_plain(r, k, v, log_w, u, s0)
    torch.testing.assert_close(y, y_ref, rtol=1e-5,
                               atol=1e-5 * float(y_ref.abs().max()))
    torch.testing.assert_close(s, s_ref, rtol=1e-5,
                               atol=1e-5 * float(s_ref.abs().max()))


def test_rglru_wrapper_checks_inputs_and_counts_launches(card):
    build.reset_launches()
    a = torch.rand((2, 5, 64), device=card)
    ops.rglru(a, a, torch.zeros((2, 64), device=card))
    ops.rglru(a, a)
    assert build.LAUNCHES["rglru"] == 2
    with pytest.raises(TypeError, match="float32"):
        rglru_cuda(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="h0"):
        rglru_cuda(a, a, torch.zeros((2, 63), device=card))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_cuda(a, a.cpu())
    with pytest.raises(ValueError, match="empty"):
        rglru_cuda(a[:, :0], a[:, :0])
    assert build.LAUNCHES["rglru"] == 2


def test_model_kernel_wrappers_check_inputs_and_count_launches(card):
    build.reset_launches()
    q, k, v = _attention_inputs(card, 1, 4, 4, 2, 1, 64, torch.float32, 0)
    pos = torch.arange(4, dtype=torch.int32, device=card)
    ops.flash_attention(q, k, v, pos, pos)     # Sq 4: decode
    assert build.LAUNCHES["flash_attention"] == 1
    assert build.LAUNCHES["flash_decode"] == 1
    assert build.LAUNCHES["flash_decode_combine"] == 1
    q2, k2, v2 = _attention_inputs(card, 1, 40, 40, 2, 1, 64, torch.float32,
                                   0)
    pos2 = torch.arange(40, dtype=torch.int32, device=card)
    ops.flash_attention(q2, k2, v2, pos2, pos2)        # fp32 prefill
    ops.flash_attention(*(t.bfloat16() for t in (q2, k2, v2)), pos2, pos2)
    assert build.LAUNCHES["flash_simt"] == 1
    assert build.LAUNCHES["flash_prefill"] == 1
    assert build.LAUNCHES["flash_attention"] == 3
    for qq, kk, vv, pp in ((q, k, v, pos), (q2, k2, v2, pos2)):
        for dt in (torch.float32, torch.bfloat16):
            a, b_, c = (t.to(dt) for t in (qq, kk, vv))
            with pytest.raises(ValueError, match="head dims"):
                flash_attention_cuda(a[..., :48], b_[..., :48], c[..., :48],
                                     pp, pp)
            with pytest.raises(ValueError, match="head dims"):
                flash_attention_cuda(a, b_, c[..., :32], pp, pp)
            with pytest.raises(TypeError):
                flash_attention_cuda(a.half(), b_.half(), c.half(), pp, pp)
            with pytest.raises(TypeError):
                flash_attention_cuda(a, b_.to(torch.float64), c, pp, pp)
            with pytest.raises(ValueError, match="CUDA"):
                flash_attention_cuda(a, b_, c, pp.cpu(), pp)
            with pytest.raises(ValueError, match="positions"):
                flash_attention_cuda(a, b_, c, pp[1:], pp)
    assert build.LAUNCHES["flash_attention"] == 3
    assert build.LAUNCHES["flash_decode"] == 1
    assert build.LAUNCHES["flash_prefill"] == 1
    r = torch.zeros((1, 3, 2, 64), device=card)
    s0 = torch.zeros((1, 2, 64, 64), device=card)
    u = torch.zeros((2, 64), device=card)
    ops.wkv6(r, r, r, r, u, s0)
    assert build.LAUNCHES["wkv6"] == 1
    with pytest.raises(TypeError, match="log_w"):
        wkv6_cuda(r, r, r, r.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="state"):
        wkv6_cuda(r, r, r, r, u, s0[:, :1])
    assert build.LAUNCHES["wkv6"] == 1


@pytest.mark.parametrize("preset", ["lmtiny", "rwkv6-3b",
                                    "recurrentgemma-2b"])
def test_serve_on_card_runs_the_kernels(card, preset):
    """Every layer's kernel once per call; rg-smoke's 40-token prompt
    wraps its 32-slot ring."""
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import _preset
    cfg = _preset(preset)
    n_rec = sum(cfg.layer_is_recurrent(i) for i in range(cfg.num_layers)) \
        if cfg.is_hybrid else 0
    n_attn = 0 if cfg.is_attention_free else cfg.num_layers - n_rec
    want = {"rglru": n_rec * 7,
            "wkv6": cfg.num_layers * 7 if cfg.is_attention_free else 0,
            # every attention layer's wrapper once per call; prefill (40
            # queries) on the design its dtype and head dim take, each of
            # the 6 decode steps on the split kernel and its combine
            "flash_attention": n_attn * 7,
            design(40, cfg.resolved_head_dim, cfg.dtype): n_attn,
            "flash_decode": n_attn * 6, "flash_decode_combine": n_attn * 6}
    build.reset_launches()
    out = serve(cfg, batch=2, prompt_len=40, gen=6, keep_logits=True)
    assert {k: v for k, v in build.LAUNCHES.items() if v} == \
        {k: n for k, n in want.items() if n}
    assert out["tokens"].shape == (2, 7)
    assert bool(torch.isfinite(out["prefill_logits"].float()).all())


def test_encdec_serve_on_card_runs_the_kernels(card):
    """seamless-smoke served on the card (fp32: the kernels held to the
    CPU's plain versions): the encoder's 2 non-causal prefill launches
    (D 16 takes the SIMT kernel), then BOS and 6 decode steps, each with
    2 self and 2 cross decode calls; the BOS logits and the tokens those
    of the same serve on the CPU."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.lm import init_lm
    from repro_torch.utils.trees import tree_map
    cfg = dataclasses.replace(get_smoke_config("seamless-m4t-large-v2"),
                              dtype="float32")
    params = init_lm(cfg, 3, torch.device("cpu"))
    build.reset_launches()
    out = serve(cfg, batch=2, prompt_len=40, gen=6, keep_logits=True,
                params=tree_map(lambda t: t.to(card), params))
    calls = 7 * 2 * 2
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {
        "flash_attention": 2 + calls, "flash_simt": 2,
        "flash_decode": calls, "flash_decode_combine": calls}
    ref = serve(cfg, batch=2, prompt_len=40, gen=6, keep_logits=True,
                params=params, device="cpu")
    # fp32 on both sides, sums in other orders through 4 blocks
    torch.testing.assert_close(out["prefill_logits"].cpu(),
                               ref["prefill_logits"], rtol=1e-4, atol=1e-4)
    assert out["tokens"].cpu().tolist() == ref["tokens"].tolist()


@pytest.mark.parametrize("shape,tile", [((64, 250), (8, 100)),
                                        ((64, 256), (8, 128)),
                                        ((7, 1000), (3, 96)),
                                        ((1, 5), (8, 100))])
def test_tile_copy_kernel_equals_plain_bitwise(card, shape, tile):
    """The analyzer's mis-tiled copy: partial edge tiles in either
    dimension copy exactly, and nothing past the array is written."""
    build.reset_launches()
    x = torch.randn(shape, device=card)
    got = tile_copy_cuda(x, tile)
    assert torch.equal(got, tile_copy_plain(x, tile))
    assert torch.equal(got, x)
    assert build.LAUNCHES["tile_copy"] == 1
    with pytest.raises(ValueError, match="1024"):
        tile_copy_cuda(x, (8, 2048))


def _spec_inputs(spec, card):
    """A thunk that calls ``spec``'s kernel at the spec's shapes (inputs
    made outside it)."""
    shapes = {o.name: o.array for o in spec.operands}
    gen = torch.Generator(device=card).manual_seed(5)

    def randn(*s):
        return torch.randn(s, generator=gen, device=card)

    name = spec.kernel
    g = (4, 512)
    w2 = torch.tensor([0.3, 0.5], device=card)
    denom, push = torch.tensor(1.2, device=card), torch.tensor(True,
                                                                device=card)
    if name == "quantize_int8":
        x = randn(*g)
        return lambda: quantize_int8_cuda(x)
    if name == "dequantize_int8":
        q, s = quantize_int8_cuda(randn(*g))
        return lambda: dequantize_int8_cuda(q, s, g)
    if name in ("pack_int4", "unpack_int4"):
        # (units, 256, inner) blocked on axis 1: the spec's units of
        # 128*inner packed bytes, so the same slots and tiles
        units, unit = shapes["p"]
        q = torch.randint(-8, 8, (units, 256, unit // 128), generator=gen,
                          device=card, dtype=torch.int8)
        if name == "pack_int4":
            return lambda: pack_int4_cuda(q, axis=1)
        p = pack_int4_cuda(q, axis=1)
        return lambda: unpack_int4_cuda(p, axis=1)
    dt = getattr(torch, spec.operands[0].dtype)
    if name == "loss_weighted_update":
        (n,), (P, _) = shapes["g"], shapes["pods"]
        gl, pods = randn(n).to(dt), randn(P, n).to(dt)
        return lambda: loss_weighted_update_cuda(
            gl, pods, denom - 0.8, torch.rand(P, generator=gen, device=card),
            denom, push)
    if name in ("dequant_merge", "dequant_merge_packed"):
        # a leaf the kernel walks as the spec's does: (units, 256) blocked
        # on its last axis (row tiles), or (outer*nb, 256, inner) blocked
        # on the middle one (column tiles)
        P = shapes["scal"][0] - 2
        if len(shapes["g"]) == 2:
            gshape, ax = shapes["g"], 2
        else:
            gshape, ax = (shapes["g"][0] // 2, 256, shapes["g"][2]), 2
        gl = randn(*gshape).to(dt)
        q = torch.randint(-7, 8, (P,) + gshape, generator=gen, device=card,
                          dtype=torch.int8)
        sc = randn(P, gshape[0], 1, *gshape[2:]).abs()
        w2 = torch.rand(P, generator=gen, device=card)
        if name == "dequant_merge":
            return lambda: dequant_merge_cuda(gl, q, sc, w2, denom, push,
                                              axis=ax)
        qp = ref.pack_nibbles_ref(q, axis=ax)
        return lambda: dequant_merge_packed_cuda(gl, qp, sc, w2, denom, push,
                                                 axis=ax)
    if name in ("flash_simt", "flash_decode", "flash_prefill"):
        q, k, v = (randn(*shapes[n]).to(dt) for n in ("q", "k", "v"))
        Sq, Skv = q.shape[1], k.shape[1]
        qp = torch.arange(Skv - Sq, Skv, dtype=torch.int32, device=card)
        kp = torch.arange(Skv, dtype=torch.int32, device=card)
        return lambda: flash_attention_cuda(q, k, v, qp, kp)
    if name == "flash_decode_combine":
        rows, splits, D = shapes["part_acc"]
        ml = randn(rows, 1, 1, splits, 2).abs()
        acc = randn(rows, 1, 1, splits, D)
        dt = getattr(torch, spec.operands[-1].dtype)
        return lambda: decode_combine(ml, acc, dt)
    if name == "wkv6":
        dt = getattr(torch, spec.operands[0].dtype)
        r, k, v = (randn(*shapes[n]).to(dt) for n in ("r", "k", "v"))
        log_w = -torch.exp(randn(*shapes["log_w"]))
        u, s0 = randn(*shapes["u"]), randn(*shapes["state"])
        return lambda: wkv6_cuda(r, k, v, log_w, u, s0)
    if name == "rglru":
        a, b, h0 = (randn(*shapes[n]) for n in ("a", "b", "h0"))
        return lambda: rglru_cuda(torch.sigmoid(a), b, h0)
    if name == "tile_copy":
        x = randn(*shapes["x"])
        return lambda: tile_copy_cuda(x, spec.operands[0].tile)
    raise KeyError(name)


SPEC_CASES = ops.kernel_lint_cases() + [("tile_copy",
                                         tile_copy_launch_spec())]


@pytest.mark.parametrize("label", [label for label, _ in SPEC_CASES])
def test_launch_matches_its_spec(card, label, tmp_path):
    """The grid, block and shared memory the profiler records for the
    kernel's launch are the ones its launch spec (the lint's input)
    computes: the profiler's shared memory is the function's static
    ``__shared__`` bytes plus the launch's dynamic bytes."""
    spec = dict(SPEC_CASES)[label]
    run = _spec_inputs(spec, card)
    run()  # builds and loads the library
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    kernels = [e for e in json.loads(trace.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    events = [e for e in kernels if spec.function in e["name"]]
    assert len(events) == 1, [e.get("name") for e in kernels]
    args = events[0]["args"]
    assert tuple(args["grid"]) == spec.grid
    assert tuple(args["block"]) == (spec.threads, 1, 1)
    assert args["shared memory"] == spec.smem + spec.static_smem, args


# ---------------------------------------------------------------------------
# Level A: the paper's CNNs on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mnist-cnn", "cifar-alexnet"])
def test_grouped_pack_unpack_on_the_cnn_trees(card, arch):
    """The int4 payload trees of a Level-A push: nearly every byte of the
    CNNs sits in a short tail (fc1 (1568, 64) is 1568 rows of one
    64-element block), one launch each way, bitwise."""
    from repro_torch.models.cnn import make_paper_model
    from repro_torch.utils.trees import tree_leaves
    params = make_paper_model(arch, torch.Generator().manual_seed(0), card)
    gen = torch.Generator(device=card).manual_seed(31)
    fmt, noise = wire.get_format("int4"), wire.GeneratorNoise(5, card)
    leaves = []
    for i, x in enumerate(tree_leaves(params)):
        delta = 1e-2 * torch.randn(x.shape, generator=gen, device=card)
        q, _, _, ax, d, _ = fmt._quantize(delta, (0, i), noise)
        leaves.append((q, d, ax))
    assert _check_group(leaves) == (1, 1)


def _gap(got, want):
    """Largest |got - want| over matching tensors, over the largest
    |want|."""
    gap = max(float((a.cpu() - b).abs().max()) for a, b in zip(got, want))
    return gap / max(float(b.abs().max()) for b in want)


@pytest.mark.parametrize("dataset", ["mnist", "cifar"])
def test_cnn_step_on_card_matches_cpu(card, dataset):
    """The loss and gradients at one set of parameters, and the parameters
    and loss after two SGD steps of the bundle's optimizer (cifar:
    momentum 0.9), on the card (cuDNN convs, TF32 off) and on the CPU, at
    the studies' mini-batch of 16.  cuDNN sums in other orders: each
    within 1e-4 of the largest magnitude, the loss after the steps within
    1e-3 (cifar's first steps blow the logits up; 32 samples land 1.8e-4
    apart).  (At 64 samples one max-pool
    window of cifar's nears a tie, and the two devices route its gradient
    to different elements: 1.4e-3 of conv1's largest gradient, with the
    card the one that agrees with fp64.)"""
    from repro_torch.core.bundles import make_paper_bundle
    from repro_torch.core.cluster import _make_step
    from repro_torch.utils.trees import (
        tree_flatten, tree_leaves, tree_map, tree_unflatten)
    batch = 16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle, _ = make_paper_bundle(dataset, n=200)
    params = bundle.init(torch.Generator().manual_seed(0), "cpu")
    data = {k: torch.as_tensor(v[:batch])
            for k, v in bundle.train_data.items()}
    step = _make_step(bundle)
    out = {}
    for dev in ("cpu", card):
        leaves, treedef = tree_flatten(tree_map(lambda x: x.to(dev), params))
        leaves = [x.requires_grad_(True) for x in leaves]
        b = {k: v.to(dev) for k, v in data.items()}
        loss = bundle.loss(tree_unflatten(treedef, leaves), b)
        grads = torch.autograd.grad(loss, leaves)
        p = tree_unflatten(treedef, [x.detach() for x in leaves])
        mom = tree_map(torch.zeros_like, p)
        for _ in range(2):
            p, mom = step(p, mom, b)
        out[dev] = (float(loss.detach()), grads, tree_leaves(p),
                    float(bundle.loss(p, b)))
    cpu, got = out["cpu"], out[card]
    assert all(x.is_cuda for x in got[2])
    gaps = (abs(got[0] - cpu[0]) / abs(cpu[0]), _gap(got[1], cpu[1]),
            _gap(got[2], cpu[2]), abs(got[3] - cpu[3]) / abs(cpu[3]))
    assert max(gaps[:3]) <= 1e-4 and gaps[3] <= 1e-3, gaps


def test_level_a_hermes_on_card_packs_every_push(card):
    """A short Hermes study on the card: each int4 push is one launch of
    the grouped pack and one of the grouped unpack."""
    from repro_torch.core.allocator import Allocation
    from repro_torch.core.bundles import make_paper_bundle
    from repro_torch.core.simulator import run_framework
    bundle, _ = make_paper_bundle("mnist", n=600, eval_batch=64)
    build.reset_launches()
    r = run_framework("hermes", bundle, num_workers=4,
                      init_alloc=Allocation(32, 16), target_acc=1.01,
                      max_iterations=16, max_wall=1e9, patience=10 ** 6,
                      hermes_cfg=HermesConfig(alpha=-0.5, lam=2,
                                              eta=bundle.eta))
    pushes = sum(p for *_, p in r.gup_trace)
    assert r.iterations == 16 and pushes > 0
    assert build.LAUNCHES["pack_int4"] == build.LAUNCHES["unpack_int4"] \
        == pushes
    assert r.bytes_by_kind["push"] == 60089 * pushes


def test_level_a_vector_engine_admission_on_card(card):
    """``engine="vector"`` at participation 0.5 under ``prob`` on the
    card: deferred pushes billed nothing, each admitted int4 push one
    pack and one unpack launch, the replicas on the card."""
    from repro_torch.core import simulator as tsim
    from repro_torch.core.allocator import Allocation
    from repro_torch.core.bundles import make_paper_bundle
    bundle, _ = make_paper_bundle("mnist", n=600, eval_batch=64)
    cfg = HermesConfig(alpha=-0.5, lam=2, eta=bundle.eta,
                       participation_rate=0.5, admission="prob")
    build.reset_launches()
    r = tsim.run_framework(
        "hermes", bundle, num_workers=4, engine="vector",
        init_alloc=Allocation(32, 16), target_acc=1.01, max_iterations=40,
        max_wall=1e9, patience=10 ** 6, hermes_cfg=cfg)
    opened = sum(p for *_, p in r.gup_trace)
    admitted = r.calls_by_kind["push"]
    deferred = [e for e in r.meter_events if e[2] == "push_deferred"]
    assert deferred and all(e[3] == 0.0 for e in deferred)
    assert admitted > 0 and admitted + len(deferred) == opened
    assert build.LAUNCHES["pack_int4"] == \
        build.LAUNCHES["unpack_int4"] == admitted
    assert r.device == "cuda:0"


def test_level_a_batch_engine_runs_on_the_host(card):
    """The batch engine with the default device: numpy columns on the
    host, no kernel launched, and the result says so."""
    from repro_torch.core.engine import ChurnTrace, SurrogateBundle
    from repro_torch.core.simulator import run_framework
    build.reset_launches()
    r = run_framework("hermes", SurrogateBundle(), num_workers=1000,
                      hermes_cfg=HermesConfig(participation_rate=0.5,
                                              n_clusters=4,
                                              compression="int8"),
                      seed=7, target_acc=2.0, patience=10 ** 9,
                      max_iterations=40 * 1000, max_sim_time=1e9,
                      churn=ChurnTrace(diurnal_period_s=600.0,
                                       battery_s=400.0, failure_rate=1e-4))
    assert r.device == "host" and r.ps_updates > 0
    assert not any(build.LAUNCHES.values())


def test_checkpoint_round_trip_on_card(card, tmp_path):
    """An async checkpoint of card tensors (fp32, bf16, int32, an int
    step) restores on the card and on the CPU bit for bit."""
    from repro_torch.checkpoint import Checkpointer, restore_tree
    gen = torch.Generator(device=card).manual_seed(0)
    tree = {"params": {"w": torch.randn(64, 33, generator=gen, device=card),
                       "b": torch.randn(17, generator=gen, device=card)
                       .to(torch.bfloat16)},
            "opt": {"n": torch.arange(5, dtype=torch.int32, device=card),
                    "step": 3},
            "step": 3}
    ck = Checkpointer(str(tmp_path), async_write=True)
    ck.save(tree, 3)
    for device in (None, "cpu"):
        back, step = ck.restore(tree, device=device)
        assert step == 3 and back["step"] == 3 and back["opt"]["step"] == 3
        for got, want in ((back["params"]["w"], tree["params"]["w"]),
                          (back["params"]["b"], tree["params"]["b"]),
                          (back["opt"]["n"], tree["opt"]["n"])):
            assert got.device.type == (device or "cuda")
            assert got.dtype == want.dtype
            assert torch.equal(got.cpu(), want.cpu())
    back, _ = restore_tree(tree, str(tmp_path), device=card)
    assert back["params"]["w"].is_cuda


@pytest.mark.parametrize("admission", ["topk", "prob"])
def test_admission_on_card(card, admission):
    """Admission on the card: ``prob`` thins the open gates by the card
    generator's draw (admitted a subset of open, the share near the
    rate), ``topk`` keeps the budget; a short lmtiny Hermes run under it
    packs, unpacks and merges once a merged round."""
    from repro_torch.dist import hermes_sync
    from repro_torch.launch.train import _preset, train_hermes
    cfg = HermesConfig(participation_rate=0.5, admission=admission)
    noise = wire.GeneratorNoise(3, card)
    gen = torch.Generator(device=card).manual_seed(2)
    n_open = n_admitted = 0
    for step in range(100):
        gates = torch.rand(64, generator=gen, device=card) < 0.5
        losses = torch.rand(64, generator=gen, device=card) + 1.0
        got = hermes_sync.admit_gates(gates, losses, cfg, round_step=step,
                                      noise=noise)
        assert got.is_cuda and not bool((got & ~gates).any())
        if admission == "prob":
            u = noise(step, hermes_sync.ADMISSION_LEAF, (64,))
            assert torch.equal(got, gates & (u < 0.5))
        else:
            assert int(got.sum()) == max(1, int(gates.sum()) // 2)
        n_open += int(gates.sum())
        n_admitted += int(got.sum())
    if admission == "prob":
        assert abs(n_admitted / n_open - 0.5) < 4.5 * (0.25 / n_open) ** 0.5
    build.reset_launches()
    out = train_hermes(_preset("lmtiny"), steps=10, batch=4, seq=32, pods=4,
                       opt_cfg=OptimizerConfig(name="adamw", lr=3e-3),
                       hcfg=HermesConfig(alpha=-0.8, lam=2,
                                         participation_rate=0.5,
                                         admission=admission),
                       log_every=10 ** 6, device=card)
    assert out["merges"] >= 1 and math.isfinite(out["global_loss"])
    for name in ("pack_int4", "unpack_int4", "dequant_merge_packed"):
        assert build.LAUNCHES[name] == out["merges"], name


class _PodKeyedNoise:
    """The int4 dither keyed by original pod id (``chip_smoke.py``'s
    ``PodKeyedNoise``): a leaf draws at the original ``(n_pods,) + leaf``
    shape and keeps the live pods' rows, so a resize rounds every
    surviving pod as the masked run does."""

    def __init__(self, seed, device, n_pods):
        self.seed, self.device, self.n_pods = seed, device, n_pods

    def __call__(self, ids):
        base = wire.GeneratorNoise(self.seed, self.device)
        n, ids = self.n_pods, list(ids)

        def draw(round_step, leaf, shape):
            if not shape or shape[0] != len(ids):
                return base(round_step, leaf, shape)
            return base(round_step, leaf, (n,) + tuple(shape[1:]))[ids]
        return draw


def _lmtiny_state(card):
    """``init_state`` of the elastic proofs: lmtiny on the card, each pod
    a small perturbation of the global model."""
    from repro_torch.dist import hermes_sync
    from repro_torch.launch.train import _preset
    from repro_torch.models.lm import init_lm
    from repro_torch.utils.trees import tree_map
    w = init_lm(_preset("lmtiny"), 0, card)

    def init(n_pods, cfg, seed, device):
        gen = torch.Generator(device=device).manual_seed(seed + 5)
        pods = tree_map(lambda g: g[None] + 1e-3 * torch.randn(
            (n_pods,) + tuple(g.shape), generator=gen, device=device), w)
        return pods, w, hermes_sync.hermes_pod_state(cfg, n_pods, device)
    return init


def test_elastic_shrink_and_grow_on_card(card):
    """The resize on the card moves the rows of the CPU's resize, bitwise:
    the survivors' rows by index, the newcomer seeded from ``w_global``
    with a fresh gate row and a zero residual, every tensor on the card."""
    from repro_torch.dist import hermes_sync
    from repro_torch.launch import elastic
    from repro_torch.utils.trees import tree_leaves, tree_map
    cfg = HermesConfig(min_live_pods=1)
    pods, w, gup = _lmtiny_state(card)(4, cfg, 0, card)
    err = tree_map(lambda x: 1e-4 * torch.ones_like(x), pods)
    state = {"pod_params": pods, "gup": gup, "error": err, "w_global": w}
    small, groups = elastic.elastic_shrink(state, [0, 2, 3], None, cfg=cfg)
    assert groups is None
    cpu = tree_map(lambda x: x.cpu(), state)
    want, _ = elastic.elastic_shrink(cpu, [0, 2, 3], None, cfg=cfg)
    for k in ("pod_params", "gup", "error"):
        for a, b in zip(tree_leaves(small[k]), tree_leaves(want[k])):
            assert a.is_cuda and torch.equal(a.cpu(), b), k
    grown, _ = elastic.elastic_grow(small, None, cfg=cfg)
    back, _ = elastic.elastic_grow(want, None, cfg=cfg)
    for k in ("pod_params", "gup", "error", "w_global"):
        for a, b in zip(tree_leaves(grown[k]), tree_leaves(back[k])):
            assert a.is_cuda and torch.equal(a.cpu(), b), k
    for a, g in zip(tree_leaves(grown["pod_params"]), tree_leaves(w)):
        assert torch.equal(a[3], g)
    assert all(not bool(e[3].any()) for e in tree_leaves(grown["error"]))
    fresh = hermes_sync.hermes_pod_state(cfg, 1, card)
    for k, v in fresh.items():
        assert torch.equal(grown["gup"][k][3:], v), k


@pytest.mark.parametrize("compression", ["int8", "int4"])
def test_rejoin_equivalence_on_card(card, compression):
    """The shrink -> grow proof at lmtiny x 4 pods on the card, bitwise,
    its merges through the wire kernels (int4 with the dither keyed by
    original pod id)."""
    from repro_torch.launch import elastic
    cfg = HermesConfig(alpha=-0.5, beta=0.1, lam=2, window=4,
                       compression=compression, rejoin_cost_rounds=0.5)
    noise = _PodKeyedNoise(3, card, 4) if compression == "int4" else None
    build.reset_launches()
    out = elastic.rejoin_pod_equivalence(
        n_pods=4, cfg=cfg, device=card, init_state=_lmtiny_state(card),
        pod_noise=noise)
    assert out["bit_identical"] and out["warmup_checked"]
    kernels = (("pack_int4", "unpack_int4", "dequant_merge_packed")
               if compression == "int4" else ("dequant_merge",))
    for name in kernels:
        assert build.LAUNCHES[name] >= 1, name


def test_merge_denominator_ignores_a_masked_pod_on_card(card):
    """A masked pod's zero weight adds nothing to the merge's denominator
    on the card: over 512 draws of four losses, pod ``i % 4`` masked and
    at least two survivors open, ``denom`` of the masked weights is
    bitwise that of the survivors' alone.  (A device reduction regroups
    with the length: with ``torch.sum`` about one draw in four differs.)"""
    from repro_torch.dist import hermes_sync
    gen = torch.Generator(device=card).manual_seed(24)
    L = torch.tensor(3.4, device=card)
    differ = []
    for i in range(512):
        keep = [p for p in range(4) if p != i % 4]
        losses = 0.2 + 4.0 * torch.rand(4, generator=gen, device=card)
        gates = torch.rand(4, generator=gen, device=card) < 0.75
        gates[i % 4] = False
        if int(gates[keep].sum()) < 2:
            gates[keep] = True
        big = hermes_sync._merge_weights(gates, losses, L)[2]
        small = hermes_sync._merge_weights(gates[keep], losses[keep], L)[2]
        if not torch.equal(big, small):
            differ.append(i)
    assert not differ, f"{len(differ)} of 512 draws differ"


@pytest.mark.parametrize("compression", ["none", "int8", "int4"])
def test_masked_round_is_the_shrunk_round_on_card(card, compression):
    """A round at 4 rows with pod ``seed % 4`` masked is bitwise the round
    at the 3 survivors' rows, over 16 seeds of random losses with every
    survivor's gate open (the demo schedule opens one gate a round, which
    cannot show a fault in the merge's denominator); int4 with the dither
    keyed by original pod id."""
    from repro_torch.core.gup import gup_gate
    from repro_torch.dist import hermes_sync
    from repro_torch.launch import elastic
    from repro_torch.utils.trees import tree_leaves
    cfg = HermesConfig(alpha=-0.5, beta=0.1, lam=2, window=4,
                       compression=compression)
    L = torch.tensor(3.4, device=card)
    differ = []
    for seed in range(16):
        dead = seed % 4
        keep = [p for p in range(4) if p != dead]
        live = torch.tensor([p != dead for p in range(4)], device=card)
        pods, w, gup = elastic._toy_pod_state(4, cfg, seed, card)
        for level in (3.0, 3.2):
            gup = gup_gate(gup, torch.full((4,), level, device=card), cfg)[1]
        gen = torch.Generator(device=card).manual_seed(100 + seed)
        losses = 1.0 + 1.9 * torch.rand(4, generator=gen, device=card)
        losses[dead] = float("nan")
        noise = _PodKeyedNoise(seed, card, 4) \
            if compression == "int4" else None
        big = hermes_sync.hermes_round(
            pods, gup, losses, w, L, cfg, live=live, round_step=5,
            noise=noise and noise(range(4)))
        small = hermes_sync.hermes_round(
            elastic.shrink_pod_tree(pods, keep),
            elastic.shrink_pod_tree(gup, keep), losses[keep], w, L, cfg,
            round_step=5, noise=noise and noise(keep))
        assert big["gates"].tolist() == live.tolist(), seed
        a = tree_leaves([big["w_global"], elastic.shrink_pod_tree(
            [big["pod_params"], big["error"] or []], keep)])
        b = tree_leaves([small["w_global"],
                         [small["pod_params"], small["error"] or []]])
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            differ.append(seed)
    assert not differ, f"seeds {differ} differ"
