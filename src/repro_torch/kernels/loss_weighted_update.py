"""Fused loss-weighted merge on the card (replaces the reference's
``kernels/loss_weighted_update.py:loss_weighted_update``).

    out = any_push ? (w1*g + sum_i w2_i*pods_i) / denom : g

one flat elementwise pass with the pods accumulated in order in fp32, for
the ``none``/``fp16`` wires.  ``g`` and ``pods`` share one dtype, fp32,
bf16 or fp16, widened on load and rounded once on store.  The scalars
travel in one device buffer, built once a group.

One launch updates every leaf of a tree (:func:`loss_weighted_update_group_cuda`;
the per-leaf wrapper is a group of one).  Each flat leaf is cut into
16-byte slots (:func:`tiles`: ``16 // itemsize`` elements) and tiles of
``TILE`` slots; the leaves' descriptors travel in the kernel's
parameters, ``GROUP_LEAVES`` a launch, and a persistent grid walks the
tiles.  A launch carries leaves of one dtype, so a tree of mixed dtypes
takes one launch a dtype.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dequant_merge import DTYPES, GROUP_LEAVES, SMS
from repro_torch.kernels.ref import loss_weighted_update_ref as loss_weighted_update_plain  # noqa: F401,E501

#: the tiling's ``constexpr``s in ``csrc/wire_kernels.cu``
SLOTS = 1               # kLwuSlots: 16-byte slots a thread takes a tile
BLOCKS_PER_SM = 4       # kLwuBlocksPerSm
TILE = build.WIRE_THREADS * SLOTS   # kLwuTile: 16-byte slots a tile

#: ``(g, pods)``: one leaf of a grouped update, ``pods`` of shape
#: ``(n_pods,) + g.shape``
Leaf = Tuple[torch.Tensor, torch.Tensor]


def tiles(n: int, itemsize: int) -> int:
    """The tiles of a flat leaf of ``n`` elements of ``itemsize`` bytes."""
    return -(-(-(-n // (16 // itemsize))) // TILE)


def grid(n_tiles: int) -> int:
    """The persistent grid of a launch over ``n_tiles`` tiles."""
    return min(n_tiles, SMS * BLOCKS_PER_SM)


def wide(ns: Sequence[int], n_pods: int) -> bool:
    """Does a launch over leaves of ``ns`` elements need 64-bit offsets:
    does a pod-stacked leaf reach 2^31 elements?"""
    return any(n_pods * n >= 1 << 31 for n in ns)


def _check(g: torch.Tensor, pods: torch.Tensor, n_pods: int,
           device: torch.device) -> None:
    for name, t in (("g", g), ("pods", pods)):
        if not t.is_cuda or t.device != device:
            raise ValueError(f"loss_weighted_update: {name} on {t.device}, "
                             f"the group on {device}; all must be on one "
                             f"card")
        if t.dtype not in DTYPES or t.dtype != g.dtype:
            raise TypeError(f"loss_weighted_update: {name} is {t.dtype}, "
                            f"expected g's dtype, one of {tuple(DTYPES)}")
        if not t.is_contiguous():
            raise ValueError(f"loss_weighted_update: {name} not contiguous")
    if tuple(pods.shape) != (n_pods,) + tuple(g.shape):
        raise ValueError(f"loss_weighted_update: pods {tuple(pods.shape)} "
                         f"vs g {tuple(g.shape)} and {n_pods} pods")


def loss_weighted_update_group_cuda(leaves: Sequence[Leaf],
                                    w1: torch.Tensor, w2: torch.Tensor,
                                    denom: torch.Tensor,
                                    any_push: torch.Tensor
                                    ) -> List[torch.Tensor]:
    """Update every leaf ``(g, pods)`` in one launch a dtype (and
    ``GROUP_LEAVES`` leaves): ``g`` an fp32, bf16 or fp16 leaf, ``pods``
    ``(n_pods,) + g.shape`` of g's dtype; ``w1``/``denom``/``any_push``:
    0-d, ``w2``: (n_pods,).  Returns the updated leaves in order."""
    if not leaves:
        return []
    device = leaves[0][0].device
    n_pods = leaves[0][1].shape[0] if leaves[0][1].ndim else 0
    for g, pods in leaves:
        _check(g, pods, n_pods, device)
    scal = torch.cat([t.reshape(-1).to(device=device, dtype=torch.float32)
                      for t in (w1, denom, any_push, w2)])
    if scal.numel() != 3 + n_pods:
        raise ValueError(f"loss_weighted_update: w2 has {scal.numel() - 3} "
                         f"weights for {n_pods} pods")
    outs = [torch.empty_like(g) for g, _ in leaves]
    for dtype, code in DTYPES.items():
        work = [(g, pods, out) for (g, pods), out in zip(leaves, outs)
                if g.numel() and g.dtype == dtype]
        for start in range(0, len(work), GROUP_LEAVES):
            chunk = work[start:start + GROUP_LEAVES]
            fields = []
            for g, pods, out in chunk:
                n, size = g.numel(), g.element_size()
                vec = n % (16 // size) == 0 and all(
                    t.data_ptr() % 16 == 0 for t in (g, pods, out))
                fields += [g.data_ptr(), pods.data_ptr(), out.data_ptr(), n,
                           int(vec), tiles(n, size)]
            desc = (ctypes.c_longlong * len(fields))(*fields)
            build.launch("loss_weighted_update", device,
                         ctypes.addressof(desc), len(chunk), scal.data_ptr(),
                         n_pods, code,
                         int(wide([g.numel() for g, _, _ in chunk], n_pods)))
    return outs


def loss_weighted_update_group_plain(leaves: Sequence[Leaf], w1, w2, denom,
                                     any_push) -> List[torch.Tensor]:
    """The grouped update as the per-leaf plain versions."""
    return [loss_weighted_update_plain(g, pods, w1, w2, denom, any_push)
            for g, pods in leaves]


def loss_weighted_update_cuda(g: torch.Tensor, pods: torch.Tensor,
                              w1: torch.Tensor, w2: torch.Tensor,
                              denom: torch.Tensor, any_push: torch.Tensor
                              ) -> torch.Tensor:
    """One leaf: a group of one (see
    :func:`loss_weighted_update_group_cuda`)."""
    return loss_weighted_update_group_cuda([(g, pods)], w1, w2, denom,
                                           any_push)[0]


def launch_spec(g_shape, n_pods: int, dtype: str = "float32"
                ) -> build.LaunchSpec:
    """The launch :func:`loss_weighted_update_cuda` makes for one leaf of
    ``g_shape`` and ``dtype``: a block's step is one tile, ``TILE`` slots
    of 16 bytes of g, of every pod and of out, ``SLOTS`` a thread."""
    n = math.prod(g_shape)
    size = getattr(torch, dtype).itemsize
    tile = TILE * (16 // size)
    return build.LaunchSpec(
        kernel="loss_weighted_update", source=build.source("wire_kernels"),
        function="loss_weighted_update_kernel",
        grid=(grid(tiles(n, size)), 1, 1), threads=build.WIRE_THREADS,
        smem=4 * n_pods,
        operands=(build.Operand("g", (n,), (tile,), dtype),
                  build.Operand("pods", (n_pods, n), (n_pods, tile), dtype),
                  build.Operand("scal", (3 + n_pods,), (3 + n_pods,),
                                "float32"),
                  build.Operand("out", (n,), (tile,), dtype)),
        accumulator="acc", template={"T": dtype}, threads_of="kThreads",
        constants={"kThreads": build.WIRE_THREADS, "kLwuSlots": SLOTS,
                   "kLwuBlocksPerSm": BLOCKS_PER_SM, "kLwuTile": TILE,
                   "kMergeLeaves": GROUP_LEAVES})


def cost(leaves, n_pods: int) -> Tuple[int, int]:
    """``(operations, bytes)`` of one grouped update over ``leaves``,
    ``(g_shape, g_dtype, pods_dtype)`` each: g and the ``n_pods`` pod
    rows read once, the update written once; ``2 + 2 * n_pods``
    operations an element."""
    ops = moved = 0
    for g_shape, g_dtype, pods_dtype in leaves:
        n = math.prod(g_shape)
        ops += n * (2 + 2 * n_pods)
        moved += n * (2 * g_dtype.itemsize + n_pods * pods_dtype.itemsize)
    return ops, moved
