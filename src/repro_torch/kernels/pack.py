"""Nibble pack / unpack on the card (replaces the reference's
``kernels/pack.py:pack_int4`` / ``unpack_int4`` Pallas kernels).

Layout: within each 256-element quantization block of the blocked
``axis``, packed byte ``k`` holds element ``k`` in its low nibble and
element ``k + 128`` in its high nibble (two's complement, [-8, 7]).  A leaf
of ``d`` elements along the axis ships ``nf = d // 256`` such blocks and a
tail of ``rem = d % 256`` elements in ``ceil(rem/2)`` bytes paired ``(k, k
+ ceil(rem/2))`` (``ref.pack_tail_ref``): the wire.

One launch packs (or unpacks) every leaf of a tree, tails included
(``*_group_cuda``; the per-leaf wrappers are a group of one).  Each leaf
is viewed as ``(outer, d, inner)`` around its blocked axis, so unlike the
reference wrapper (``pack.py:52-69``) no ``moveaxis`` copy is made, and
cut into tiles (:func:`plan_leaf`): ``TILE_SLOTS`` 16-byte slots of its
whole blocks, then its tail one byte an item.  The leaves' descriptors
travel in the kernel's parameters, ``GROUP_LEAVES`` a launch; a
persistent grid walks the tiles.  Bound by HBM bytes; see
``csrc/wire_kernels.cu``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import BLOCK, HALF
from repro_torch.kernels.ref import pack_nibbles_ref as pack_int4_plain
from repro_torch.kernels.ref import pack_tail_ref
from repro_torch.kernels.ref import unpack_nibbles_ref as unpack_int4_plain
from repro_torch.kernels.ref import unpack_tail_ref

#: the tiling's ``constexpr``s in ``csrc/wire_kernels.cu``
SLOT = 16               # kSlotBytes: packed bytes a slot (one uint4)
UNROLL = 4              # kPackUnroll: slots a thread takes a tile
TILE_SLOTS = build.WIRE_THREADS * UNROLL   # kTileSlots (a tail tile: bytes)
GROUP_LEAVES = 32       # kPackLeaves: leaf descriptors a launch carries
BLOCKS_PER_SM = 4       # kPackBlocksPerSm
SMS = 132               # the H100 SXM's streaming multiprocessors

#: ``(array, d, axis)``: one leaf of a grouped call.  Pack: ``array`` the
#: int8 nibbles, ``d`` real elements along ``axis`` out of its (possibly
#: zero-padded) length.  Unpack: ``array`` the wire bytes of a leaf of
#: ``d`` elements along ``axis``.
Leaf = Tuple[torch.Tensor, int, int]


class PackPlan(NamedTuple):
    """How the kernels walk one leaf: the nibble side as ``(outer, qrow,
    inner)`` with ``d <= qrow`` real rows, ``nf`` whole blocks and ``rem``
    tail elements; the wire as ``(outer, prow, inner)``; ``body_tiles``
    tiles of ``TILE_SLOTS`` 16-byte slots over the whole blocks and
    ``tail_tiles`` of ``TILE_SLOTS`` bytes over the tails."""
    outer: int
    d: int
    inner: int
    nf: int
    rem: int
    qrow: int
    prow: int
    body_tiles: int
    tail_tiles: int

    @property
    def tiles(self) -> int:
        return self.body_tiles + self.tail_tiles


def wire_rows(d: int) -> int:
    """Wire bytes along a blocked axis of ``d`` elements."""
    return d // BLOCK * HALF + (d % BLOCK + 1) // 2


def plan_leaf(q_shape, axis: int, d=None) -> PackPlan:
    """The tiles of a leaf whose nibble side has ``q_shape``, blocked on
    ``axis`` with ``d`` real elements (default: all of ``q_shape[axis]``)."""
    return _plan(tuple(q_shape), axis, d)


@functools.lru_cache(maxsize=1024)
def _plan(s, axis: int, d) -> PackPlan:
    """:func:`plan_leaf`, cached: a round plans the same leaves each time."""
    s = s or (1,)
    ax = axis % len(s)
    qrow = s[ax]
    d = qrow if d is None else int(d)
    if not 0 < d <= qrow:
        raise ValueError(f"{d} real elements on axis {ax} of {s}")
    outer, inner = math.prod(s[:ax]), math.prod(s[ax + 1:])
    nf, rem = divmod(d, BLOCK)
    tail = (rem + 1) // 2 * inner
    return PackPlan(outer, d, inner, nf, rem, qrow, wire_rows(d),
                    -(-outer * nf * HALF * inner // (SLOT * TILE_SLOTS)),
                    -(-outer * tail // TILE_SLOTS))


def fast_div_magic(divisor: int) -> Tuple[int, int]:
    """``(m, s)`` with ``(n * m) >> s == n // divisor`` for every ``n <
    2**31``: ``s = 31 + ceil(log2 divisor)``, ``m = ceil(2**s /
    divisor)`` (at most 2**32, so ``n * m`` fits 64 bits).  The 32-bit
    walk's ``quotient``."""
    s = 31 + (divisor - 1).bit_length()
    return -(-(1 << s) // divisor), s


def wide(plans: Sequence[PackPlan]) -> bool:
    """Does a launch over ``plans`` need 64-bit offsets: does a leaf's
    nibble side reach 2^31 bytes?"""
    return any(p.outer * p.qrow * p.inner >= 1 << 31 for p in plans)


def vectorized(plan: PackPlan, src: torch.Tensor, dst: torch.Tensor) -> bool:
    """Can the leaf's whole blocks move as 16-byte slots: both base
    pointers and, with more than one outer index, both sides' rows along
    it 16-byte aligned?  Else the kernel walks them byte by byte."""
    rows = plan.outer == 1 or (plan.qrow * plan.inner % SLOT == 0
                               and plan.prow * plan.inner % SLOT == 0)
    return rows and src.data_ptr() % SLOT == 0 and dst.data_ptr() % SLOT == 0


def grid(tiles: int) -> int:
    """The persistent grid of a launch over ``tiles`` tiles."""
    return min(tiles, SMS * BLOCKS_PER_SM)


def _view3(shape, axis: int, width: int):
    """(outer, d, inner) of ``shape`` around ``axis``; ``d % width == 0``."""
    ax = axis % len(shape)
    d = shape[ax]
    if d % width:
        raise ValueError(f"axis {ax} of {tuple(shape)} is not a whole number "
                         f"of {width}-wide blocks")
    return math.prod(shape[:ax]), d, math.prod(shape[ax + 1:]), ax


def _check(x: torch.Tensor, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int8:
        raise TypeError(f"{name}: expected int8, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if x.numel() == 0 or x.ndim == 0:
        raise ValueError(f"{name}: expected a non-empty array of rank >= 1")


def _resized(shape, ax: int, n: int) -> List[int]:
    out = list(shape)
    out[ax] = n
    return out


def _unpack_plan(p: torch.Tensor, d: int, axis: int):
    """The plan of a wire leaf ``p`` of ``d`` elements, and ``q``'s shape."""
    ax = axis % p.ndim
    if d < 1 or p.shape[ax] != wire_rows(d):
        raise ValueError(f"unpack_int4: axis {ax} of {tuple(p.shape)} is "
                         f"not the {wire_rows(max(d, 0))} wire bytes of "
                         f"{d} elements")
    q_shape = _resized(p.shape, ax, d)
    return plan_leaf(q_shape, ax, d), q_shape


@functools.lru_cache(maxsize=1024)
def _plan_fields(plan: PackPlan) -> Tuple[int, ...]:
    """The descriptor fields of a leaf that its plan fixes: outer, inner,
    nf, qrow, prow, rem, the tile counts and the two magic numbers."""
    return (plan.outer, plan.inner, plan.nf, plan.qrow, plan.prow, plan.rem,
            plan.body_tiles, plan.tail_tiles, *fast_div_magic(8 * plan.inner),
            *fast_div_magic(max(plan.nf, 1)))


def _launch(kernel: str, work) -> None:
    """``work``: ``(plan, src, dst)`` per leaf; one launch per
    ``GROUP_LEAVES`` of them."""
    for start in range(0, len(work), GROUP_LEAVES):
        chunk = work[start:start + GROUP_LEAVES]
        fields = []
        for plan, src, dst in chunk:
            fields += [src.data_ptr(), dst.data_ptr(),
                       int(vectorized(plan, src, dst)), *_plan_fields(plan)]
        desc = (ctypes.c_longlong * len(fields))(*fields)
        build.launch(kernel, chunk[0][1].device, ctypes.addressof(desc),
                     len(chunk), int(wide([p for p, _, _ in chunk])))


def _same_card(name: str, leaves: Sequence[Leaf]) -> None:
    for x, _, _ in leaves:
        _check(x, name)
        if x.device != leaves[0][0].device:
            raise ValueError(f"{name}: leaves on {x.device} and "
                             f"{leaves[0][0].device}; all must be on one "
                             f"card")


def pack_int4_group_cuda(leaves: Sequence[Leaf]) -> List[torch.Tensor]:
    """Pack every leaf ``(q, d, axis)`` into its wire bytes in one launch:
    ``q`` int8 nibbles in [-8, 7] with ``d`` real elements along ``axis``
    (the rest, the quantizer's padding, is not read)."""
    _same_card("pack_int4", leaves)
    outs, work = [], []
    for q, d, axis in leaves:
        plan = plan_leaf(q.shape, axis, d)
        p = torch.empty(_resized(q.shape, axis % q.ndim, plan.prow),
                        dtype=torch.int8, device=q.device)
        outs.append(p)
        work.append((plan, q, p))
    _launch("pack_int4", work)
    return outs


def unpack_int4_group_cuda(leaves: Sequence[Leaf]) -> List[torch.Tensor]:
    """Unpack every wire leaf ``(p, d, axis)`` into its ``d`` int8 nibbles
    along ``axis`` in one launch (exact, sign included)."""
    _same_card("unpack_int4", leaves)
    outs, work = [], []
    for p, d, axis in leaves:
        plan, q_shape = _unpack_plan(p, d, axis)
        q = torch.empty(q_shape, dtype=torch.int8, device=p.device)
        outs.append(q)
        work.append((plan, p, q))
    _launch("unpack_int4", work)
    return outs


def pack_int4_group_plain(leaves: Sequence[Leaf]) -> List[torch.Tensor]:
    """The grouped pack as the per-leaf plain versions: the whole blocks
    by ``pack_nibbles_ref``, the tail by ``pack_tail_ref``, concatenated
    (the reference's ``dist/wire.py:Int4Format._encode_hinted``)."""
    outs = []
    for q, d, axis in leaves:
        ax = axis % q.ndim
        plan = plan_leaf(q.shape, ax, d)
        parts = []
        if plan.nf:
            parts.append(pack_int4_plain(q.narrow(ax, 0, plan.nf * BLOCK),
                                         axis=ax))
        if plan.rem:
            parts.append(pack_tail_ref(q.narrow(ax, plan.nf * BLOCK,
                                                plan.rem), axis=ax))
        outs.append(parts[0] if len(parts) == 1 else torch.cat(parts, ax))
    return outs


def unpack_int4_group_plain(leaves: Sequence[Leaf]) -> List[torch.Tensor]:
    """The grouped unpack as the per-leaf plain versions (the reference's
    ``Int4Format.unpack_payload``)."""
    outs = []
    for p, d, axis in leaves:
        ax = axis % p.ndim
        plan, _ = _unpack_plan(p, d, ax)
        head = plan.nf * HALF
        parts = []
        if plan.nf:
            parts.append(unpack_int4_plain(p.narrow(ax, 0, head), axis=ax))
        if plan.rem:
            parts.append(unpack_tail_ref(p.narrow(ax, head, plan.prow - head),
                                         plan.rem, axis=ax))
        outs.append(parts[0] if len(parts) == 1 else torch.cat(parts, ax))
    return outs


def pack_int4_cuda(q: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """int8 nibbles in [-8, 7] -> packed int8 with ``axis`` (whole blocks)
    halved: a group of one (see :func:`pack_int4_group_cuda`)."""
    _check(q, "pack_int4")
    _, d, _, ax = _view3(q.shape, axis, BLOCK)
    return pack_int4_group_cuda([(q, d, ax)])[0]


def unpack_int4_cuda(p: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4_cuda` (exact, sign included)."""
    _check(p, "unpack_int4")
    _, dh, _, ax = _view3(p.shape, axis, HALF)
    return unpack_int4_group_cuda([(p, 2 * dh, ax)])[0]


def launch_spec(kernel: str, shape, axis: int = -1) -> build.LaunchSpec:
    """The launch ``kernel`` (``"pack_int4"``, ``shape`` = q's, or
    ``"unpack_int4"``, ``shape`` = p's; whole blocks) makes for one leaf.
    A tile is ``TILE_SLOTS`` 16-byte slots of p: within one unit (o, b) of
    ``128*inner`` packed bytes when a unit holds whole tiles, else whole
    units, with q's two halves of each unit beside them."""
    pack = kernel == "pack_int4"
    _, d, _, ax = _view3(tuple(shape), axis, BLOCK if pack else HALF)
    plan = plan_leaf(shape if pack else _resized(shape, ax, 2 * d), ax)
    units, unit, tile = plan.outer * plan.nf, HALF * plan.inner, \
        SLOT * TILE_SLOTS
    if unit >= tile:
        p_tile, q_tile = (1, tile), (1, 2, tile)
    else:
        rows = min(units, tile // unit)
        p_tile, q_tile = (rows, unit), (rows, 2, unit)
    packed = build.Operand("p", (units, unit), p_tile, "int8")
    nibbles = build.Operand("q", (units, 2, unit), q_tile, "int8")
    return build.LaunchSpec(
        kernel=kernel, source=build.source("wire_kernels"),
        function=f"{kernel}_kernel", grid=(grid(plan.tiles), 1, 1),
        threads=build.WIRE_THREADS, smem=0,
        operands=(nibbles, packed) if pack else (packed, nibbles),
        threads_of="kThreads",
        constants={"kBlock": BLOCK, "kHalf": HALF,
                   "kThreads": build.WIRE_THREADS, "kSlotBytes": SLOT,
                   "kPackUnroll": UNROLL, "kTileSlots": TILE_SLOTS,
                   "kPackLeaves": GROUP_LEAVES,
                   "kPackBlocksPerSm": BLOCKS_PER_SM})


def cost(kernel: str, leaves) -> Tuple[int, int]:
    """``(operations, bytes)`` of one grouped call of ``kernel`` over
    ``leaves``, ``(shape, d, axis)`` each as in :data:`Leaf` (``shape`` the
    array's): the ``d`` real nibbles of each leaf read once and its wire
    bytes written once (pack), or the wire bytes read and ``d`` nibbles
    written (unpack).  No arithmetic is counted."""
    moved = 0
    for shape, d, axis in leaves:
        s = tuple(shape) or (1,)
        ax = axis % len(s)
        rest = math.prod(s) // s[ax]
        wire = wire_rows(d) if kernel == "pack_int4" else s[ax]
        moved += rest * (d + wire)
    return 0, moved
