"""The grouped int4 pack and unpack (one launch packs every leaf of a
tree, tails included) on the CPU: the plain route against the JAX
reference, the tile plan the CUDA kernels walk, and ``encode_tree``'s use
of the grouped route against the per-leaf one.

Inputs are made with numpy from a seed and handed to both sides.  The
kernels' walk (``csrc/wire_kernels.cu``, ``pack_tiles``) is repeated in
numpy over the planned tiles, magic-number quotients and all: every
output byte is written exactly once and equals the plain version.
"""
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.dist import wire as jwire
from repro.kernels import pack as jpack
from repro.kernels import ref as jref

from repro_torch.dist import compression as tcomp
from repro_torch.dist import wire as twire
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pack as pk
from repro_torch.kernels import ref as tref

from torch_parity import leaf_shapes
from torch_parity import to_numpy as _n
from torch_parity import to_torch as _t

# (nibble shape, axis, real elements d): row leaves, column leaves at
# inner 256 and 768, a tail-only leaf, odd tails, blocks and a tail, and a
# middle axis with an inner extent that breaks 16-byte rows
LEAVES = [
    ((3, 512), 1, 512),
    ((2, 512, 256), 1, 512),
    ((2, 256, 768), 1, 256),
    ((4, 12, 256), 2, 64),
    ((3, 256), 1, 77),
    ((5, 256), 1, 1),
    ((2, 512), 1, 300),
    ((2, 512, 3), 1, 300),
    ((3, 2, 768, 3, 4), 2, 768),
    ((768,), 0, 700),
]


def _nibbles(shape, d, axis, seed):
    """int8 nibbles in [-8, 7]; past ``d`` along ``axis`` the quantizer's
    zero padding."""
    q = np.random.default_rng(seed).integers(-8, 8, size=shape,
                                             dtype=np.int8)
    idx = [slice(None)] * len(shape)
    idx[axis] = slice(d, None)
    q[tuple(idx)] = 0
    return q


def _reference_pack(q, d, axis):
    """The reference's composition (``dist/wire.py:_encode_hinted``): the
    Pallas pack (interpret mode) over the whole blocks, ``pack_tail_ref``
    over the tail."""
    nf, rem = divmod(d, 256)
    qj = jnp.asarray(q)
    parts = []
    if nf:
        head = jnp.take(qj, jnp.arange(nf * 256), axis=axis)
        parts.append(jpack.pack_int4(head, axis=axis, interpret=True))
    if rem:
        tail = jnp.take(qj, jnp.arange(nf * 256, d), axis=axis)
        parts.append(jref.pack_tail_ref(tail, axis=axis))
    return np.asarray(parts[0] if len(parts) == 1
                      else jnp.concatenate(parts, axis))


def _reference_unpack(p, d, axis):
    """The reference's ``Int4Format.unpack_payload`` composition."""
    nf, rem = divmod(d, 256)
    pj = jnp.asarray(p)
    parts = []
    if nf:
        head = jnp.take(pj, jnp.arange(nf * 128), axis=axis)
        parts.append(jpack.unpack_int4(head, axis=axis, interpret=True))
    if rem:
        tail = jnp.take(pj, jnp.arange(nf * 128, p.shape[axis]), axis=axis)
        parts.append(jref.unpack_tail_ref(tail, rem, axis=axis))
    return np.asarray(parts[0] if len(parts) == 1
                      else jnp.concatenate(parts, axis))


def test_grouped_plain_equals_reference_on_every_leaf_kind():
    leaves = [(_t(_nibbles(s, d, ax, i)), d, ax)
              for i, (s, ax, d) in enumerate(LEAVES)]
    packed = tops.pack_int4_group(leaves)
    assert len(packed) == len(leaves)
    for (q, d, ax), p in zip(leaves, packed):
        want = _reference_pack(_n(q), d, ax)
        assert p.dtype == torch.int8
        np.testing.assert_array_equal(_n(p), want)
        assert p.shape[ax] == pk.wire_rows(d)
    back = tops.unpack_int4_group([(p, d, ax)
                                   for p, (_, d, ax) in zip(packed, leaves)])
    for (q, d, ax), p, u in zip(leaves, packed, back):
        np.testing.assert_array_equal(_n(u), _reference_unpack(_n(p), d, ax))
        np.testing.assert_array_equal(_n(u), _n(q.narrow(ax, 0, d)))


@pytest.mark.parametrize("shape,axis,d", LEAVES)
def test_each_leaf_round_trips_through_the_group_of_one(shape, axis, d):
    q = _t(_nibbles(shape, d, axis, sum(shape) + d))
    p, = tops.pack_int4_group([(q, d, axis)])
    # the plain per-leaf route of the parent: head, tail, concatenated
    nf, rem = divmod(d, 256)
    parts = ([tref.pack_nibbles_ref(q.narrow(axis, 0, nf * 256).contiguous(),
                                    axis=axis)] if nf else []) + \
        ([tref.pack_tail_ref(q.narrow(axis, nf * 256, rem), axis=axis)]
         if rem else [])
    assert torch.equal(p, torch.cat(parts, axis))
    u, = tops.unpack_int4_group([(p, d, axis)])
    assert torch.equal(u, q.narrow(axis, 0, d))


def test_grouped_plain_takes_unpadded_nibbles_and_payload_rows():
    """A trimmed q (axis exactly ``d``) packs as its padded form does, and
    a pod row ``a[i]`` of a stacked wire array (a view off the start of
    its storage) unpacks as a copy of it does."""
    qp = _t(_nibbles((3, 4, 512), 300, 2, 3))
    q = qp.narrow(2, 0, 300).contiguous()
    a, b = tops.pack_int4_group([(qp, 300, 2), (q, 300, 2)])
    assert torch.equal(a, b)
    rows = tops.unpack_int4_group([(a[i], 300, 1) for i in range(3)])
    for i, r in enumerate(rows):
        assert torch.equal(r, q[i])


def test_grouped_calls_check_their_leaves():
    q = torch.zeros((2, 512), dtype=torch.int8)
    with pytest.raises(ValueError, match="real elements"):
        tops.pack_int4_group([(q, 513, 1)])
    with pytest.raises(ValueError, match="wire bytes"):
        tops.unpack_int4_group([(torch.zeros((2, 149), dtype=torch.int8),
                                 300, 1)])
    assert tops.pack_int4_group([]) == []
    assert tops.unpack_int4_group([]) == []
    for fn in (pk.pack_int4_group_cuda, pk.unpack_int4_group_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn([(q, 512, 1)])


# ---------------------------------------------------------------------------
# the plan and the kernels' walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("divisor", [1, 2, 3, 7, 8, 24, 125, 2048, 6144,
                                     12345, 2 ** 20 + 1, 2 ** 31 - 1])
def test_fast_division_is_exact_below_two_to_the_31(divisor):
    m, s = pk.fast_div_magic(divisor)
    assert m <= 1 << 32 and s <= 62
    rng = np.random.default_rng(divisor)
    ns = np.concatenate([rng.integers(0, 1 << 31, 20000), np.arange(4096),
                         (1 << 31) - 1 - np.arange(4096),
                         divisor * np.arange(1, 64) - 1,
                         divisor * np.arange(0, 64)])
    ns = ns[(ns >= 0) & (ns < 1 << 31)].astype(np.uint64)
    got = (ns * np.uint64(m)) >> np.uint64(s)
    np.testing.assert_array_equal(got, ns // np.uint64(divisor))


@pytest.mark.parametrize("shape,axis,d,body,tail", [
    ((3, 512), 1, 512, 1, 0),                 # 6 units of 8 slots
    ((2, 512, 256), 1, 512, 8, 0),            # 4 units of 2048 slots
    ((2, 256, 768), 1, 256, 12, 0),           # 2 units of 6144 slots
    ((4, 12, 256), 2, 64, 0, 2),              # 48 x 32 tail bytes
    ((2, 512, 3), 1, 300, 1, 1),
    ((4, 2, 768, 12, 64), 2, 768, 144, 0),    # lm100m's wq at 2 layers
    ((4, 12, 768, 12, 64), 2, 768, 864, 0),   # and at 12
])
def test_plan_counts_tiles(shape, axis, d, body, tail):
    plan = pk.plan_leaf(shape, axis, d)
    assert (plan.body_tiles, plan.tail_tiles) == (body, tail)
    assert plan.prow == pk.wire_rows(d) == d // 256 * 128 + (d % 256 + 1) // 2
    assert plan.tiles == body + tail
    assert pk.grid(plan.tiles) == min(plan.tiles, 132 * 4)


def test_plan_of_the_lm100m_tree_is_one_32_bit_launch():
    shapes = leaf_shapes("lm100m", 4)
    plans = []
    for s in shapes:
        ax = twire.block_axis(s)
        d = s[ax]
        plans.append(pk.plan_leaf(s[:ax] + (-(-d // 256) * 256,) + s[ax + 1:],
                                  ax, d))
    assert len(plans) == 14 <= pk.GROUP_LEAVES
    assert not pk.wide(plans)
    tails = [p for p in plans if p.rem]
    assert len(tails) == 2 and all(p.nf == 0 and p.tail_tiles == 2
                                   for p in tails)
    packed = sum(p.outer * p.prow * p.inner for p in plans)
    assert packed == sum(math.prod(s) for s in shapes) // 2   # no odd tails
    slots = sum(p.outer * p.nf * 8 * p.inner for p in plans)
    assert sum(p.body_tiles for p in plans) == sum(
        -(-p.outer * p.nf * 8 * p.inner // pk.TILE_SLOTS) for p in plans)
    assert slots * 16 + sum(p.outer * p.prow * p.inner for p in tails) \
        == packed
    # every whole-block leaf moves as 16-byte slots on fresh buffers
    for p in plans:
        assert p.outer == 1 or p.qrow * p.inner % 16 == 0
        assert p.rem or p.prow * p.inner % 16 == 0


def test_plan_chooses_64_bit_offsets_at_two_to_the_31():
    small = pk.plan_leaf((2 ** 15, 2 ** 16 - 256), 1)
    big = pk.plan_leaf((2 ** 15, 2 ** 16), 1)
    assert not pk.wide([small]) and pk.wide([small, big])


def test_plan_chooses_the_scalar_walk_for_misaligned_leaves():
    buf = torch.zeros(4 * 512 * 3 + 1, dtype=torch.int8)
    q = buf[:4 * 512 * 3].view(4, 512, 3)
    off = buf[1:].view(4, 512, 3)
    p = torch.zeros((4, 256, 3), dtype=torch.int8)
    plan = pk.plan_leaf(q.shape, 1)
    assert pk.vectorized(plan, q, p)                 # 1536, 768 B rows
    assert not pk.vectorized(plan, off, p)           # base off by one
    tail = pk.plan_leaf((4, 512, 3), 1, 300)         # prow 150: 450 B rows
    assert not pk.vectorized(tail, q, torch.zeros((4, 150, 3),
                                                  dtype=torch.int8))
    one = pk.plan_leaf((1, 512, 3), 1, 300)          # one outer index
    assert pk.vectorized(one, q, p)


def _join(lo, hi):
    return (((hi.astype(np.int32) & 0xF) << 4)
            | (lo.astype(np.int32) & 0xF)).astype(np.uint8).view(np.int8)


def _lo(v):
    return (((v.astype(np.int32) & 0xF) ^ 8) - 8).astype(np.int8)


def _hi(v):
    return (v.astype(np.int32) >> 4).astype(np.int8)


def _walk(kernel, leaves, threads=256):
    """Repeat ``pack_tiles`` over the launch's tiles in numpy: returns
    each leaf's output (flat) and how many times each byte was written."""
    pack = kernel == "pack_int4"
    work, tile0 = [], 0
    for x, d, ax in leaves:
        if pack:
            plan = pk.plan_leaf(x.shape, ax, d)
            out = np.zeros(plan.outer * plan.prow * plan.inner, np.int8)
        else:
            q_shape = list(x.shape)
            q_shape[ax] = d
            plan = pk.plan_leaf(q_shape, ax, d)
            out = np.zeros(math.prod(q_shape), np.int8)
        work.append((plan, _n(x).ravel(), out, np.zeros(out.size, np.int64),
                     tile0, tile0 + plan.body_tiles))
        tile0 += plan.tiles
    li = 0
    for t in range(tile0):
        while li + 1 < len(work) and t >= work[li + 1][4]:
            li += 1
        plan, src, dst, hits, t0, tail0 = work[li]
        half = 128 * plan.inner
        qo, po = plan.qrow * plan.inner, plan.prow * plan.inner
        nf = plan.nf
        lane = (np.arange(pk.UNROLL)[:, None] * threads
                + np.arange(threads)[None, :]).ravel()
        if t < tail0:
            unit = half // 16
            s = ((t - t0) * pk.TILE_SLOTS + lane).astype(np.uint64)
            s = s[s < plan.outer * nf * unit]
            m_u, s_u = pk.fast_div_magic(8 * plan.inner)
            m_n, s_n = pk.fast_div_magic(max(nf, 1))
            r = (s * np.uint64(m_u)) >> np.uint64(s_u)
            o = (r * np.uint64(m_n)) >> np.uint64(s_n)
            s, r, o = (a.astype(np.int64) for a in (s, r, o))
            b = r - o * nf
            c = (s - r * unit) * 16
            qa = (o * qo + b * 2 * half + c)[:, None] + np.arange(16)
            pa = (o * po + b * half + c)[:, None] + np.arange(16)
            if pack:
                dst[pa] = _join(src[qa], src[qa + half])
                np.add.at(hits, pa.ravel(), 1)
            else:
                dst[qa], dst[qa + half] = _lo(src[pa]), _hi(src[pa])
                np.add.at(hits, qa.ravel(), 1)
                np.add.at(hits, (qa + half).ravel(), 1)
            continue
        htail = (plan.rem + 1) // 2
        tail = htail * plan.inner
        e = (t - tail0) * pk.TILE_SLOTS + lane
        e = e[e < plan.outer * tail]
        o, x = e // tail, e % tail
        paired = x // plan.inner + htail < plan.rem
        pi = o * po + nf * half + x
        qi = o * qo + nf * 2 * half + x
        if pack:
            hi = np.where(paired, src[np.where(paired, qi + tail, qi)], 0)
            dst[pi] = _join(src[qi], hi)
            np.add.at(hits, pi, 1)
        else:
            dst[qi] = _lo(src[pi])
            dst[qi[paired] + tail] = _hi(src[pi[paired]])
            np.add.at(hits, qi, 1)
            np.add.at(hits, qi[paired] + tail, 1)
    return [(dst, hits) for _, _, dst, hits, _, _ in work]


def test_kernel_walk_writes_every_byte_once_and_equals_plain():
    leaves = [(_t(_nibbles(s, d, ax, 40 + i)), d, ax)
              for i, (s, ax, d) in enumerate(LEAVES)]
    want = tops.pack_int4_group(leaves)
    for (got, hits), w in zip(_walk("pack_int4", leaves), want):
        assert (hits == 1).all()
        np.testing.assert_array_equal(got, _n(w).ravel())
    wires = [(w, d, ax) for w, (_, d, ax) in zip(want, leaves)]
    for (got, hits), (q, d, ax) in zip(_walk("unpack_int4", wires), leaves):
        assert (hits == 1).all()
        np.testing.assert_array_equal(got, _n(q.narrow(ax, 0, d)).ravel())


def test_kernel_walk_over_a_launch_of_lm100m_like_leaves():
    """The leaf lookup across a launch: tail-only, column and row leaves
    interleaved, their tiles numbered across the launch."""
    specs = [((2, 12, 256), 2, 64), ((2, 256, 768), 1, 256),
             ((6, 768), 1, 768), ((2, 12, 256), 2, 64),
             ((1, 512, 256), 1, 512)]
    leaves = [(_t(_nibbles(s, d, ax, i)), d, ax)
              for i, (s, ax, d) in enumerate(specs)]
    want = tops.pack_int4_group(leaves)
    for (got, hits), w in zip(_walk("pack_int4", leaves), want):
        assert (hits == 1).all()
        np.testing.assert_array_equal(got, _n(w).ravel())


def test_word_nibble_arithmetic_equals_the_byte_functions():
    """``join4`` / ``lo4`` / ``hi4`` (four bytes to a 32-bit word,
    ``__vsub4`` a per-byte subtraction) equal ``nibble_join`` /
    ``nibble_lo`` / ``nibble_hi`` on every byte value in every lane."""
    def vsub4(a, b):
        out = np.zeros_like(a)
        for k in range(4):
            sh = np.uint32(8 * k)
            out |= ((((a >> sh) & np.uint32(0xFF))
                     - ((b >> sh) & np.uint32(0xFF))) & np.uint32(0xFF)) << sh
        return out

    rng = np.random.default_rng(0)
    byte = np.arange(256, dtype=np.uint32)
    for lane in range(4):
        other = rng.integers(0, 256, (256, 4)).astype(np.uint32)
        other[:, lane] = byte
        words = sum(other[:, k] << np.uint32(8 * k) for k in range(4))
        m4, x8 = np.uint32(0x0F0F0F0F), np.uint32(0x08080808)
        lo = vsub4((words & m4) ^ x8, np.full_like(words, x8))
        hi = vsub4(((words >> np.uint32(4)) & m4) ^ x8,
                   np.full_like(words, x8))
        as_bytes = words.view(np.uint8).reshape(-1, 4).view(np.int8)
        np.testing.assert_array_equal(
            lo.view(np.uint8).reshape(-1, 4).view(np.int8), _lo(as_bytes))
        np.testing.assert_array_equal(
            hi.view(np.uint8).reshape(-1, 4).view(np.int8), _hi(as_bytes))
        # join4 of the two halves gives the bytes back
        joined = (lo & m4) | ((hi & m4) << np.uint32(4))
        np.testing.assert_array_equal(joined, words)
        lo_b, hi_b = _lo(as_bytes), _hi(as_bytes)
        np.testing.assert_array_equal(_join(lo_b, hi_b), as_bytes)


def test_launch_specs_describe_the_16_byte_tiles():
    spec = pk.launch_spec("pack_int4", (4, 2, 768, 12, 64), 2)
    q, p = spec.operands
    assert p.array == (24, 98304) and p.tile == (1, 16384)
    assert q.array == (24, 2, 98304) and q.tile == (1, 2, 16384)
    assert spec.grid == (144, 1, 1) and spec.smem == 0
    row = pk.launch_spec("unpack_int4", (64, 256))
    assert row.operands[0].tile == (128, 128) and row.grid == (1, 1, 1)


# ---------------------------------------------------------------------------
# encode_tree through the grouped route
# ---------------------------------------------------------------------------

def _per_leaf_encode_tree(tree, error, round_step, noise):
    """Today's per-leaf int4 path, spelled out: quantize, pack the head
    and the tail of each leaf, then unpack and decode it."""
    fmt = twire.get_format("int4")
    pays, rec, err = {}, {}, {}
    for i, k in enumerate(sorted(tree)):
        x = tree[k] + error[k]
        q, scale, s, ax, d, nb = fmt._quantize(x, (round_step, i), noise)
        nf, rem = d // 256, d % 256
        parts = []
        if nf:
            parts.append(tref.pack_nibbles_ref(
                q.narrow(ax, 0, nf * 256).contiguous(), axis=ax))
        if rem:
            parts.append(tref.pack_tail_ref(q.narrow(ax, nf * 256, rem),
                                            axis=ax))
        packed = parts[0] if len(parts) == 1 else torch.cat(parts, dim=ax)
        pays[k] = {"q_packed": packed, "scales": scale}
        parts = []
        if nf:
            parts.append(tref.unpack_nibbles_ref(
                packed.narrow(ax, 0, nf * 128).contiguous(), axis=ax))
        if rem:
            parts.append(tref.unpack_tail_ref(
                packed.narrow(ax, nf * 128, packed.shape[ax] - nf * 128),
                rem, axis=ax))
        qt = parts[0] if len(parts) == 1 else torch.cat(parts, dim=ax)
        rec[k] = twire.BlockedIntFormat.decode(
            fmt, {"q": qt, "scales": scale}, x.shape, x.dtype)
        err[k] = x - rec[k]
    return pays, rec, err


@pytest.mark.parametrize("tree_name", ["mixed", "lmtiny"])
def test_encode_tree_grouped_equals_per_leaf_path(tree_name):
    if tree_name == "mixed":
        shapes = [(3, 512), (3, 2, 70), (4, 12, 64), (2, 300, 3),
                  (3, 768, 4), ()]
    else:
        shapes = leaf_shapes("lmtiny", 3)
    rng = np.random.default_rng(len(shapes))
    tree = {f"l{i:02d}": _t(rng.normal(size=s).astype(np.float32))
            for i, s in enumerate(shapes)}
    error = {k: _t(0.01 * rng.normal(size=tuple(v.shape)).astype(np.float32))
             for k, v in tree.items()}
    noise = twire.GeneratorNoise(9, torch.device("cpu"))
    pays, rec, err = tcomp.encode_tree(tree, "int4", error=error,
                                       round_step=6, noise=noise)
    want_p, want_r, want_e = _per_leaf_encode_tree(tree, error, 6, noise)
    for k in tree:
        for key in ("q_packed", "scales"):
            assert torch.equal(pays[k][key], want_p[k][key]), (k, key)
        assert torch.equal(rec[k], want_r[k]), k
        assert torch.equal(err[k], want_e[k]), k
    dec = tcomp.decode_tree(pays, tree, "int4")
    for k in tree:
        assert torch.equal(dec[k], rec[k])
    only, none_r, none_e = tcomp.encode_tree(tree, "int4", error=error,
                                             round_step=6, noise=noise,
                                             with_residual=False)
    assert none_r is None and none_e is None
    for k in tree:
        assert torch.equal(only[k]["q_packed"], pays[k]["q_packed"])


def test_encode_tree_packs_and_unpacks_once_a_tree(monkeypatch):
    """The int4 format hands every leaf to one grouped pack and, for the
    residual, one grouped unpack; the other formats keep their loop."""
    calls = []
    for name in ("pack_int4_group", "unpack_int4_group"):
        real = getattr(tops, name)

        def spy(leaves, real=real, name=name):
            calls.append((name, len(leaves)))
            return real(leaves)

        monkeypatch.setattr(tops, name, spy)
    rng = np.random.default_rng(2)
    tree = {k: _t(rng.normal(size=s).astype(np.float32))
            for k, s in (("a", (3, 512)), ("b", (2, 70)), ("c", (4, 256)))}
    tcomp.encode_tree(tree, "int4")
    assert calls == [("pack_int4_group", 3), ("unpack_int4_group", 3)]
    calls.clear()
    tcomp.encode_tree(tree, "int8")
    assert calls == []


def test_int4_encode_of_one_leaf_matches_reference_wire():
    """The per-leaf encode (a group of one) still ships the reference's
    wire bytes for the same nibbles."""
    x = np.random.default_rng(4).normal(size=(3, 300)).astype(np.float32)
    u = np.random.default_rng(5).uniform(size=(3, 512)).astype(np.float32)
    fmt = twire.get_format("int4")
    got = fmt.encode(_t(x), key=(0, 0), noise=lambda r, i, s: u.reshape(s))
    q = fmt._quantize(_t(x), (0, 0), lambda r, i, s: u.reshape(s))[0]
    np.testing.assert_array_equal(_n(got["q_packed"]),
                                  _reference_pack(_n(q), 300, 1))
    assert jwire.block_axis((3, 300)) == twire.block_axis((3, 300))
