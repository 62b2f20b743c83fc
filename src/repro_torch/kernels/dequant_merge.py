"""Fused dequant + loss-weighted merge on the card (replaces the
reference's ``kernels/dequant_merge.py:dequant_merge`` (int8) and
``dequant_merge_packed`` (int4)).

    out = any_push ? (denom*g + sum_i w2_i * (q_i*s_i)) / denom : g

over the blocked wire payload of the pod-stacked push deltas: the dequant
(and for int4 the unpack) happens in registers, so no dequantized fp32
delta tree is written to HBM.  ``denom``, ``any_push`` and ``w2`` travel in
one small device buffer (no host sync), built once a merge.

One launch merges every leaf of a tree (``*_group_cuda``; the per-leaf
wrappers are a group of one).  Each leaf is viewed as ``(outer, d,
inner)`` around its blocked axis and cut into tiles (:func:`plan_leaf`):
a run of ``ROW_UNITS`` whole 256-blocks when the blocked axis is the
contiguous one (``inner == 1``), else ``(o, block, COL_PAIRS`` row pairs,
``4*tc`` columns).  The leaves' descriptors travel in the kernel's
parameters, ``GROUP_LEAVES`` a launch; a persistent grid walks the tiles.
Only the real ``d`` elements are written, so ``g`` is never padded; the
int8 kernel reads the trimmed wire ``q`` where it lies, and the int4
kernel reads the wire's short-paired tail as it is.  ``g`` is fp32, bf16
or fp16 (:data:`DTYPES`), widened on load and rounded once on store, as
the reference's kernels take any float leaf; a launch carries leaves of
one dtype, so a tree of mixed dtypes takes one launch a dtype.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import BLOCK, HALF
from repro_torch.kernels.ref import dequant_merge_packed_ref as dequant_merge_packed_plain  # noqa: E501
from repro_torch.kernels.ref import dequant_merge_ref as dequant_merge_plain

#: the tiling's ``constexpr``s in ``csrc/wire_kernels.cu``
ROW_UNITS = 32          # kRowUnits: 256-blocks a row tile
COL_PAIRS = 32          # kColPairs: row pairs (j, j + 128) a column tile
COL_WIDTH = 256         # kColWidth: most columns a column tile holds
GROUP_LEAVES = 32       # kMergeLeaves: leaf descriptors a launch carries
BLOCKS_PER_SM = 4       # kMergeBlocksPerSm
SMS = 132               # the H100 SXM's streaming multiprocessors

#: the leaf dtypes the merges (and ``loss_weighted_update``) take, and the
#: launchers' code for each
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: ``(g, payload, scales, axis)``: one leaf of a grouped merge, ``axis``
#: blocked in the pod-stacked payload (never 0, the pod axis)
Leaf = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]


class LeafPlan(NamedTuple):
    """How the kernel walks one leaf: ``g`` as ``(outer, d, inner)``,
    ``nb`` blocks of the blocked axis; ``prow`` payload rows per pod and
    outer index (``d`` for int8; int4 bytes: ``nb*128`` canonical, or
    ``nf*128 + ceil(rem/2)`` on the trimmed wire), ``htail`` the int4
    pairing distance in the last block; ``tc`` threads across the columns
    of a column tile (0: row tiles) and ``tiles`` the leaf's tile count."""
    outer: int
    d: int
    inner: int
    nb: int
    prow: int
    htail: int
    tc: int
    tiles: int


def plan_leaf(g_shape, axis: int, prow=None, htail: int = HALF) -> LeafPlan:
    """The tiles of a global leaf of ``g_shape`` whose pod-stacked payload
    is blocked on ``axis`` (``axis - 1`` of ``g``); ``prow`` defaults to
    the int8 wire's ``d``."""
    gs = tuple(g_shape) or (1,)
    ax = axis % (len(gs) + 1)
    outer, d, inner = math.prod(gs[:ax - 1]), gs[ax - 1], math.prod(gs[ax:])
    nb = -(-d // BLOCK)
    if inner == 1:
        tc, tiles = 0, -(-outer * nb // ROW_UNITS)
    else:
        # a power of two of 4-column threads, at least 8 so a tile's row
        # pairs fit the block, at most COL_WIDTH / 4
        tc = min(max(1 << (-(-inner // 4) - 1).bit_length(), 8),
                 COL_WIDTH // 4)
        tiles = outer * nb * (HALF // COL_PAIRS) * -(-inner // (4 * tc))
    return LeafPlan(outer, d, inner, nb, d if prow is None else prow, htail,
                    tc, tiles)


def wide(plans: Sequence[LeafPlan], n_pods: int) -> bool:
    """Does a launch over ``plans`` need 64-bit offsets: does a pod-stacked
    payload, scale array or ``g`` of one of them reach 2^31 elements?"""
    return any(max(p.outer * p.d * p.inner, n_pods * p.outer * p.prow
                   * p.inner, n_pods * p.outer * p.nb * p.inner) >= 1 << 31
               for p in plans)


def grid(tiles: int) -> int:
    """The persistent grid of a launch over ``tiles`` tiles."""
    return min(tiles, SMS * BLOCKS_PER_SM)


def smem_bytes(plans: Sequence[LeafPlan], n_pods: int) -> int:
    """Dynamic shared bytes of a launch: ``w2``, and a column tile's row of
    scales per pod when a leaf has column tiles."""
    cols = any(p.tc for p in plans)
    return 4 * n_pods * (1 + (COL_WIDTH if cols else 0))


def _check(name: str, g: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
           axis: int):
    """Device, dtype and axis checks shared by both merges; returns
    ``(g.shape or (1,), ax, d, nb)``."""
    for arg, t, dt in (("g", g, tuple(DTYPES)), ("q", q, (torch.int8,)),
                       ("scales", scales, (torch.float32,))):
        if t.device != g.device or not t.is_cuda:
            raise ValueError(f"{name}: {arg} on {t.device}, g on {g.device}; "
                             f"all must be on one card")
        if t.dtype not in dt:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected one of "
                            f"{dt}")
    if not (g.is_contiguous() and q.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError(f"{name}: g, the payload and scales must be "
                         f"contiguous")
    gs = tuple(g.shape) or (1,)
    ax = axis % q.ndim
    if ax == 0:
        raise ValueError("blocked axis must not be the pod axis")
    d = gs[ax - 1]
    return gs, ax, d, -(-d // BLOCK)


def _int8_plan(g, q, scales, axis) -> LeafPlan:
    gs, ax, d, nb = _check("dequant_merge", g, q, scales, axis)
    n_pods = q.shape[0]
    want_s = (n_pods,) + gs[:ax - 1] + (nb,) + gs[ax:]
    if tuple(q.shape) != (n_pods,) + gs or tuple(scales.shape) != want_s:
        raise ValueError(f"dequant_merge: payload {tuple(q.shape)} / scales "
                         f"{tuple(scales.shape)} do not match g {gs} blocked "
                         f"on axis {ax}")
    return plan_leaf(gs, ax)


def _int4_plan(g, q_packed, scales, axis) -> LeafPlan:
    gs, ax, d, nb = _check("dequant_merge_packed", g, q_packed, scales,
                           axis)
    n_pods = q_packed.shape[0]
    rem = d % BLOCK
    trimmed = (d // BLOCK) * HALF + (rem + 1) // 2
    prow = q_packed.shape[ax]
    want_s = (n_pods,) + gs[:ax - 1] + (nb,) + gs[ax:]
    if prow not in (nb * HALF, trimmed) or tuple(q_packed.shape) != \
            (n_pods,) + gs[:ax - 1] + (prow,) + gs[ax:] or \
            tuple(scales.shape) != want_s:
        raise ValueError(f"dequant_merge_packed: payload "
                         f"{tuple(q_packed.shape)} / scales "
                         f"{tuple(scales.shape)} do not match g {gs} "
                         f"blocked on axis {ax}")
    htail = HALF if prow == nb * HALF or not rem else (rem + 1) // 2
    return plan_leaf(gs, ax, prow, htail)


def _scal(w2, denom, any_push, device) -> torch.Tensor:
    """``[denom, any_push, w2...]`` in fp32 on ``device``."""
    return torch.cat([t.reshape(-1).to(device=device, dtype=torch.float32)
                      for t in (denom, any_push, w2)])


def _run(name: str, leaves: Sequence[Leaf], plan_fn, w2, denom, any_push
         ) -> List[torch.Tensor]:
    """Check and plan every leaf, then launch the kernel once per
    ``GROUP_LEAVES`` leaves of one dtype; returns the merged leaves in
    order."""
    if not leaves:
        return []
    plans = [plan_fn(*leaf) for leaf in leaves]
    n_pods = leaves[0][1].shape[0]
    device = leaves[0][0].device
    if any(q.shape[0] != n_pods or g.device != device
           for g, q, _, _ in leaves):
        raise ValueError(f"{name}: every leaf needs {n_pods} pods on "
                         f"{device}")
    scal = _scal(w2, denom, any_push, device)
    if scal.numel() != 2 + n_pods:
        raise ValueError(f"{name}: w2 has {scal.numel() - 2} weights for "
                         f"{n_pods} pods")
    outs = [torch.empty_like(g) for g, _, _, _ in leaves]
    for dtype, code in DTYPES.items():
        work = [(leaf, out, p) for leaf, out, p in zip(leaves, outs, plans)
                if p.tiles and leaf[0].dtype == dtype]
        for start in range(0, len(work), GROUP_LEAVES):
            chunk = work[start:start + GROUP_LEAVES]
            fields = []
            for (g, q, scales, _), out, p in chunk:
                extent = p.d if p.inner == 1 else p.inner
                run = 4 * g.element_size()  # four elements: one access
                vec = (extent % 4 == 0 and (p.inner > 1 or p.prow % 4 == 0)
                       and g.data_ptr() % run == 0
                       and out.data_ptr() % run == 0
                       and q.data_ptr() % 4 == 0)
                fields += [g.data_ptr(), out.data_ptr(), q.data_ptr(),
                           scales.data_ptr(), p.outer, p.d, p.inner, p.nb,
                           p.prow, p.htail, p.tc, int(vec), p.tiles]
            desc = (ctypes.c_longlong * len(fields))(*fields)
            build.launch(name, device, ctypes.addressof(desc), len(chunk),
                         scal.data_ptr(), n_pods, code,
                         int(wide([p for _, _, p in chunk], n_pods)))
    return outs


def dequant_merge_group_cuda(leaves: Sequence[Leaf], w2: torch.Tensor,
                             denom: torch.Tensor, any_push: torch.Tensor
                             ) -> List[torch.Tensor]:
    """Merge every int8 leaf ``(g, q, scales, axis)`` in one launch:
    ``q`` the pod-stacked trimmed int8 wire array, ``(n_pods,) + g.shape``;
    ``scales`` one fp32 per 256-block of ``axis``; ``w2``: (n_pods,);
    ``denom``/``any_push``: 0-d."""
    return _run("dequant_merge", leaves, _int8_plan, w2, denom, any_push)


def dequant_merge_packed_group_cuda(leaves: Sequence[Leaf], w2: torch.Tensor,
                                    denom: torch.Tensor,
                                    any_push: torch.Tensor
                                    ) -> List[torch.Tensor]:
    """Merge every int4 leaf ``(g, q_packed, scales, axis)`` in one launch:
    ``q_packed`` the pod-stacked wire array, whole blocks nibble-packed and
    the tail short-paired (or canonical, a whole padded block)."""
    return _run("dequant_merge_packed", leaves, _int4_plan, w2, denom,
                any_push)


def dequant_merge_group_plain(leaves: Sequence[Leaf], w2, denom, any_push
                              ) -> List[torch.Tensor]:
    """The grouped int8 merge as the per-leaf plain versions."""
    return [dequant_merge_plain(g, q, s, w2, denom, any_push, axis=ax)
            for g, q, s, ax in leaves]


def dequant_merge_packed_group_plain(leaves: Sequence[Leaf], w2, denom,
                                     any_push) -> List[torch.Tensor]:
    """The grouped int4 merge as the per-leaf plain versions."""
    return [dequant_merge_packed_plain(g, q, s, w2, denom, any_push,
                                       axis=ax)
            for g, q, s, ax in leaves]


def dequant_merge_cuda(g: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                       w2: torch.Tensor, denom: torch.Tensor,
                       any_push: torch.Tensor, *, axis: int = -1
                       ) -> torch.Tensor:
    """One int8 leaf: a group of one (see :func:`dequant_merge_group_cuda`)."""
    return dequant_merge_group_cuda([(g, q, scales, axis)], w2, denom,
                                    any_push)[0]


def dequant_merge_packed_cuda(g: torch.Tensor, q_packed: torch.Tensor,
                              scales: torch.Tensor, w2: torch.Tensor,
                              denom: torch.Tensor, any_push: torch.Tensor, *,
                              axis: int = -1) -> torch.Tensor:
    """One int4 leaf: a group of one (see
    :func:`dequant_merge_packed_group_cuda`)."""
    return dequant_merge_packed_group_cuda([(g, q_packed, scales, axis)], w2,
                                           denom, any_push)[0]


def launch_spec(kernel: str, g_shape, n_pods: int, axis: int = -1,
                dtype: str = "float32") -> build.LaunchSpec:
    """The launch ``kernel`` (``"dequant_merge"`` or
    ``"dequant_merge_packed"``) makes for one global leaf of ``g_shape``
    and ``dtype`` and ``n_pods`` pods, blocked on ``axis`` of the
    pod-stacked payload (canonical int4).  A block's step over row tiles
    is 8 whole 256-blocks (a warp each): 8 x 256 g/out elements, as many
    int8 bytes or half as many packed bytes per pod, and one scale per pod
    and block (a gather).  Over a column tile it is ``COL_PAIRS`` row
    pairs (j, j+128) of one block by ``4*tc`` columns, and the tile's row
    of scales."""
    gs = tuple(g_shape) or (1,)
    ax = axis % (len(gs) + 1)
    plan = plan_leaf(gs, ax, (-(-gs[ax - 1] // BLOCK) * HALF
                              if kernel == "dequant_merge_packed" else None))
    ob, inner, P = plan.outer * plan.nb, plan.inner, n_pods
    packed = kernel == "dequant_merge_packed"
    if plan.tc == 0:
        rows = build.WIRE_THREADS // 32
        g = ((ob, BLOCK), (rows, BLOCK))
        q = ((P, ob, HALF if packed else BLOCK),
             (P, rows, HALF if packed else BLOCK))
        scales = build.Operand("scales", (P, ob), (P, rows), "float32",
                               gather=True)
    else:
        w = 4 * plan.tc
        g = ((2 * ob, HALF, inner), (2, COL_PAIRS, w))
        q = ((P, ob, HALF, inner), (P, 1, COL_PAIRS, w)) if packed else \
            ((P, 2 * ob, HALF, inner), (P, 2, COL_PAIRS, w))
        scales = build.Operand("scales", (P, ob, inner), (P, 1, w),
                               "float32")
    return build.LaunchSpec(
        kernel=kernel, source=build.source("wire_kernels"),
        function=f"{kernel}_kernel", grid=(grid(plan.tiles), 1, 1),
        threads=build.WIRE_THREADS, smem=smem_bytes([plan], P),
        operands=(build.Operand("g", *g, dtype),
                  build.Operand("q_packed" if packed else "q", *q, "int8"),
                  scales,
                  build.Operand("scal", (2 + P,), (2 + P,), "float32"),
                  build.Operand("out", *g, dtype)),
        accumulator="acc", template={"T": dtype}, threads_of="kThreads",
        constants={"kBlock": BLOCK, "kHalf": HALF,
                   "kThreads": build.WIRE_THREADS, "kRowUnits": ROW_UNITS,
                   "kColPairs": COL_PAIRS, "kColWidth": COL_WIDTH,
                   "kMergeLeaves": GROUP_LEAVES,
                   "kMergeBlocksPerSm": BLOCKS_PER_SM})


def cost(leaves, n_pods: int) -> Tuple[int, int]:
    """``(operations, bytes)`` of one grouped merge (int8 or packed int4)
    over ``leaves``, ``(g_shape, g_dtype, payload_shape, scales_shape)``
    each: g, the payload bytes and the fp32 scales read once, the merged
    leaf written once; ``2 + 3 * n_pods`` operations an element (each
    pod's dequantize, weight and add, then the scale and divide)."""
    ops = moved = 0
    for g_shape, g_dtype, q_shape, s_shape in leaves:
        n = math.prod(g_shape)
        ops += n * (2 + 3 * n_pods)
        moved += 2 * n * g_dtype.itemsize + math.prod(q_shape) \
            + 4 * math.prod(s_shape)
    return ops, moved
