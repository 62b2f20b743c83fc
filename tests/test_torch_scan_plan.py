"""The launch plans of the WKV6 and RG-LRU scan kernels, on the CPU: what
``kernels/rwkv6_scan.py:plan`` and ``kernels/rglru_scan.py`` compute for
the C launchers (grid, threads, shared bytes, the vector path), held to
the card's limits and to the constants of ``csrc/model_kernels.cu``.
Nothing launches."""
import pytest
import torch

from repro_torch.analysis.tiles import constexprs
from repro_torch.kernels import build
from repro_torch.kernels import rglru_scan as lru
from repro_torch.kernels import rwkv6_scan as wkv

SMEM_PER_BLOCK = 232448   # H100: the most a block can opt in to
STATIC_SMEM = 48 * 1024   # static __shared__ and unattributed dynamic
SMS = 132


def _source_constants():
    return constexprs(build.source("model_kernels").read_text())


def test_python_constants_mirror_the_source():
    src = _source_constants()
    assert (src["kWkvKeys"], src["kWkvCols"], src["kWkvSteps"],
            src["kWkvSlots"]) == (wkv.KEYS, wkv.COLS, wkv.STEPS, wkv.SLOTS)
    assert (src["kLruChannels"], src["kLruSteps"], src["kLruStages"]) == \
        (lru.CHANNELS, lru.STEPS, lru.STAGES)


@pytest.mark.parametrize("D", wkv.HEAD_DIMS)
@pytest.mark.parametrize("T", [1, 2, 16, 37, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_plan_fits_the_card(D, T, dtype):
    pl = wkv.plan(D, T, dtype)
    lanes = pl.keys // pl.run          # lanes of a column group
    assert pl.threads % 32 == 0 and pl.threads <= 1024
    assert pl.threads == D // wkv.COLS * lanes
    # the reduce-scatter leaves 4 lanes one column each, within a warp
    assert 4 <= lanes <= 32 and 32 % lanes == 0
    assert pl.run in (2, 4, 8, 16) and pl.keys % pl.run == 0
    # a head is one cluster: at most 8 blocks (the portable limit)
    assert pl.blocks * pl.keys == D and 1 <= pl.blocks <= 8
    assert wkv.STEPS % pl.blocks == 0  # rows of y a block writes
    assert 0 <= pl.smem <= SMEM_PER_BLOCK and pl.smem % 16 == 0
    if T == 1:
        assert (pl.keys, pl.blocks, pl.smem) == (D, 1, 16 * D)
    else:
        assert pl.keys == wkv.KEYS


def test_wkv6_plan_at_rwkv6_3b():
    """B 4, 40 heads of 64, bf16: 640 blocks of 64 threads in prefill,
    ~4.8 an SM, all resident (37,120 shared bytes a block); decode keeps
    a head in one block of 64 threads (16 keys each)."""
    spec = wkv.launch_spec((4, 256, 40, 64), "bfloat16")
    assert spec.grid == (640, 1, 1) and spec.threads == 64
    assert spec.smem == 37120 and spec.static_smem == 0
    assert SMEM_PER_BLOCK // spec.smem * SMS >= spec.grid[0]  # resident
    assert spec.grid[0] / SMS > 4
    dec = wkv.launch_spec((4, 1, 40, 64), "bfloat16")
    assert dec.grid == (160, 1, 1) and dec.threads == 64
    assert dec.smem == 1024
    # the largest: fp32 at D 128 opts in past 48 KB
    assert STATIC_SMEM < wkv.plan(128, 256, "float32").smem == 94720


def test_wkv6_plan_smem_counts_the_ring_and_the_rows():
    """u, two buffers of partial y rows, the fp32 rows of 16 keys and of
    v, and two ring slots of r, k, v (bf16) and log_w (fp32)."""
    D, S = 64, wkv.STEPS
    want = 4 * D + 2 * S * D * 4 + S * (4 * 16 + D) * 4 \
        + 2 * S * D * (3 * 2 + 4)
    assert wkv.plan(D, 256).smem == want
    assert wkv.plan(D, 256, "float32").smem == want + 2 * S * D * 3 * 2


@pytest.mark.parametrize("D", [8, 48, 256])
def test_wkv6_plan_rejects_other_head_dims(D):
    with pytest.raises(ValueError):
        wkv.plan(D, 16)


@pytest.mark.parametrize("B,W,blocks", [(4, 2560, 320), (1, 33, 2),
                                        (2, 24, 2), (3, 100, 10),
                                        (1, 32, 1)])
def test_rglru_grid(B, W, blocks):
    assert lru.grid(B, W) == blocks
    assert lru.launch_spec((B, 64, W)).grid == (blocks, 1, 1)


def test_rglru_ring_keeps_24kb_in_flight_a_block():
    """Three of the four slots are in flight while one is stepped: 24 KB
    of a and b a block, 2-3 blocks an SM at recurrentgemma-2b."""
    in_flight = (lru.STAGES - 1) * lru.STEPS * lru.CHANNELS * 2 * 4
    assert in_flight == 24 * 1024
    spec = lru.launch_spec((4, 2560, 2560))
    assert spec.threads == 32 and spec.smem == 0
    assert spec.static_smem == 32768 <= STATIC_SMEM
    assert 2 <= spec.grid[0] / SMS <= 3


def test_rglru_vector_path_needs_w_by_4_and_aligned_bases():
    x = torch.zeros(4 * 64 + 4)
    assert lru.vector_path(64, x[:256], x[4:260])
    assert not lru.vector_path(64, x[1:257])        # 4 bytes off
    assert not lru.vector_path(30, x[:240])         # W % 4 != 0
    assert lru.vector_path(2560)
