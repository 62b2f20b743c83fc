"""The analyzer's bad-tiles fixture on the card (replaces the reference's
``launch/analyze.py:selftest_bad_tiles``, a ``pallas_call`` copy of a
``(64, 250)`` fp32 array in ``(8, 100)`` blocks on an ``(8, 3)`` grid).

The copy is right; its tiling is wrong on purpose, which is what the
tile lint must catch: 100 does not divide 250, so the last column tile
is partial (the kernel guards the columns past the array, as Pallas
masks a partial edge block), and :func:`launch_spec` describes that
tiling for ``analysis/tiles.py``.  See ``csrc/fixture_kernels.cu``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

SHAPE = (64, 250)
TILE = (8, 100)


def tile_copy_plain(x: torch.Tensor, tile: Tuple[int, int] = TILE
                    ) -> torch.Tensor:
    """The same copy as a loop over the same tiles, each a slice (a slice
    past the array's edge is cut, as the kernel's guard cuts it)."""
    tr, tc = tile
    out = torch.empty_like(x)
    for i in range(0, x.shape[0], tr):
        for j in range(0, x.shape[1], tc):
            out[i:i + tr, j:j + tc] = x[i:i + tr, j:j + tc]
    return out


def _grid(shape, tile) -> Tuple[int, int, int]:
    return (-(-shape[0] // tile[0]), -(-shape[1] // tile[1]), 1)


def tile_copy_cuda(x: torch.Tensor, tile: Tuple[int, int] = TILE
                   ) -> torch.Tensor:
    """Launch the CUDA copy: one block of ``tile[1]`` threads per tile."""
    if not x.is_cuda:
        raise ValueError(f"tile_copy: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"tile_copy: expected a contiguous 2-D float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    tr, tc = tile
    if x.numel() == 0 or tr < 1 or not 1 <= tc <= 1024:
        raise ValueError(f"tile_copy: shape {tuple(x.shape)}, tile {tile} "
                         f"(at most 1024 columns)")
    out = torch.empty_like(x)
    build.launch("tile_copy", x.device, x.data_ptr(), out.data_ptr(),
                 x.shape[0], x.shape[1], tr, tc)
    return out


def launch_spec(shape: Tuple[int, int] = SHAPE,
                tile: Tuple[int, int] = TILE) -> build.LaunchSpec:
    """The launch :func:`tile_copy_cuda` makes for ``shape``: the
    deliberately bad tiling the analyzer's self-test lints."""
    shape, tile = tuple(shape), tuple(tile)
    ops = tuple(build.Operand(name, shape, tile, "float32")
                for name in ("x", "out"))
    return build.LaunchSpec(
        kernel="tile_copy", source=build.source("fixture_kernels"),
        function="tile_copy_kernel", grid=_grid(shape, tile),
        threads=tile[1], smem=0, operands=ops)


def cost(shape: Tuple[int, int] = SHAPE) -> Tuple[int, int]:
    """``(operations, bytes)`` of one copy of an fp32 ``shape``: read and
    written once, no arithmetic."""
    return 0, 2 * 4 * shape[0] * shape[1]
