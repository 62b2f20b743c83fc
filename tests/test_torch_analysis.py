"""The port's static analyzer (``repro_torch.analysis``,
``repro_torch.launch.analyze``) against the reference's
(``repro.analysis``, ``repro.launch.analyze``) on the CPU: the bad-tiles
fixture's copy, tile-lint parity, host-sync parity, the port's own Hopper
rules, the round loop's fetch contract, and the cache constructors'
device default."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from repro.analysis import PallasTileLint, RetraceGuard
from repro.analysis import AnalysisError as JAnalysisError
from repro.analysis import analyze as janalyze

from repro_torch.analysis import (
    AnalysisError, HostSyncGuard, KernelTileLint, Target, analyze,
)
from repro_torch.config import HermesConfig, OptimizerConfig
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import build, ops, pack, tile_copy
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as ttrain
from repro_torch.launch.analyze import selftest_bad_tiles
from repro_torch.models import attention as A
from repro_torch.models import lm
from repro_torch.models import rglru as G
from repro_torch.models import rwkv as R

from torch_parity import CHILD_ENV

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# The bad-tiles fixture: the reference's pallas_call against the port's copy
# ---------------------------------------------------------------------------

def _reference_bad(x):
    """``selftest_bad_tiles``'s closure (``repro/launch/analyze.py:493-505``),
    verbatim."""
    def copy_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...]

    def bad(x):
        # BUG (deliberate): 100 does not divide 250 and is not a lane
        # multiple of 128
        return pl.pallas_call(
            copy_kernel,
            grid=(64 // 8, 3),
            in_specs=[pl.BlockSpec((8, 100), lambda i, j: (i, j))],
            out_specs=pl.BlockSpec((8, 100), lambda i, j: (i, j)),
            out_shape=jax.ShapeDtypeStruct((64, 250), jnp.float32),
            interpret=True)(x)

    return bad(x)


def _fixture_input():
    return np.random.default_rng(0).standard_normal(
        tile_copy.SHAPE).astype(np.float32)


def test_plain_copy_equals_reference_fixture_bitwise():
    x = _fixture_input()
    want = np.asarray(_reference_bad(jnp.asarray(x)))
    got = tile_copy.tile_copy_plain(torch.from_numpy(x)).numpy()
    assert not np.isnan(want).any()
    assert np.array_equal(want, x)   # Pallas masks the partial edge block
    assert np.array_equal(got, want)


def test_tile_copy_wrapper_refuses_cpu_and_the_spec_is_the_reference_grid():
    with pytest.raises(ValueError, match="CUDA"):
        tile_copy.tile_copy_cuda(torch.zeros(tile_copy.SHAPE))
    spec = tile_copy.launch_spec()
    assert spec.grid == (64 // 8, 3, 1) and spec.threads == 100
    assert spec.kernel in build.LAUNCHES
    assert spec.source == build.source("fixture_kernels")


# ---------------------------------------------------------------------------
# tile-misaligned: parity with the reference's _lint_mapping
# ---------------------------------------------------------------------------

def _reference_mapping(array, block, dtype):
    """The reference lint's view of a block mapping, fed the shapes
    directly (on jax 0.9 its own read of a BlockMapping finds nothing)."""
    return SimpleNamespace(
        array_shape_dtype=SimpleNamespace(shape=array, dtype=dtype),
        block_shape=block, origin="case")


def _classes(violations):
    return {v.cls for v in violations}


def _port_operand(array, block, dtype):
    return build.Operand("x", tuple(array), tuple(block), dtype)


def test_fixture_block_mappings_misalign_in_both_lints():
    closed = jax.make_jaxpr(_reference_bad)(
        jax.ShapeDtypeStruct(tile_copy.SHAPE, jnp.float32))
    eqn, = [e for e in closed.jaxpr.eqns if e.primitive.name == "pallas_call"]
    mappings = eqn.params["grid_mapping"].block_mappings
    assert len(mappings) == 2
    for bm in mappings:
        array = tuple(bm.array_aval.shape)
        block = tuple(b.block_size for b in bm.block_shape)
        dtype = str(bm.array_aval.dtype)
        assert (array, block) == (tile_copy.SHAPE, tile_copy.TILE)
        want = PallasTileLint()._lint_mapping(
            "fixture", _reference_mapping(array, block, dtype))
        got = KernelTileLint()._lint_operand(
            "fixture", _port_operand(array, block, dtype))
        assert "tile-misaligned" in _classes(want)
        assert "tile-misaligned" in _classes(got)
        # and the port's own spec of its kernel carries the same tiling
        assert {(o.array, o.tile) for o in tile_copy.launch_spec().operands} \
            == {(array, block)}


@pytest.mark.parametrize("array,block,dtype", [
    ((64, 250), (8, 100), "float32"),
    ((64, 256), (8, 128), "float32"),
    ((64, 256), (16, 256), "float32"),
    ((50, 512), (16, 128), "float32"),
    ((48, 512), (16, 128), "bfloat16"),
    ((4, 512), (4, 512), "int8"),
    ((3, 7, 384), (1, 7, 128), "int8"),
    ((3, 7, 384), (2, 7, 128), "float32"),
    ((1000,), (256,), "float32"),
    ((1024,), (256,), "float32"),
])
def test_tile_misaligned_agrees_with_reference(array, block, dtype):
    want = PallasTileLint()._lint_mapping(
        "case", _reference_mapping(array, block, dtype))
    got = KernelTileLint()._lint_operand(
        "case", _port_operand(array, block, dtype))
    assert ("tile-misaligned" in _classes(want)) == \
        ("tile-misaligned" in _classes(got))
    divides = all(a % b == 0 for a, b in zip(array, block))
    assert ("tile-misaligned" in _classes(got)) == (not divides)


# ---------------------------------------------------------------------------
# tile-below-minimum: the Hopper rule, pinned on its own cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("array,tile,dtype,gather,fires", [
    ((64, 400), (8, 100), "float32", False, True),    # 400 B
    ((64, 256), (8, 32), "float32", False, False),    # 128 B
    ((64, 256), (8, 64), "float32", False, False),    # 256 B
    ((64, 256), (8, 128), "int8", False, False),      # 128 B
    ((64, 256), (8, 64), "bfloat16", False, False),   # 128 B
    ((64, 256), (8, 48), "bfloat16", False, True),    # 96 B
    ((64, 50), (8, 50), "float32", False, False),     # full extent: exempt
    ((8, 64), (2, 1), "float32", True, False),        # a gather: exempt
    ((8, 64), (2, 1), "float32", False, True),        # 4 B
])
def test_tile_below_minimum_segment_rule(array, tile, dtype, gather, fires):
    op = build.Operand("x", array, tile, dtype, gather=gather)
    got = _classes(KernelTileLint()._lint_operand("case", op))
    assert ("tile-below-minimum" in got) == fires


@pytest.mark.parametrize("threads,fires", [(100, True), (96, False),
                                           (256, False), (33, True)])
def test_tile_below_minimum_thread_rule(threads, fires):
    spec = dataclasses.replace(tile_copy.launch_spec((64, 256), (8, 128)),
                               threads=threads)
    got = _classes(KernelTileLint().check(Target(launches=(spec,))))
    assert ("tile-below-minimum" in got) == fires


# ---------------------------------------------------------------------------
# low-precision-accumulate and pack-pairing-drift
# ---------------------------------------------------------------------------

SUM_KERNEL = """
#include <cuda_bf16.h>
template <typename T>
__global__ void sum_kernel(const __nv_bfloat16* __restrict__ x,
                           __nv_bfloat16* __restrict__ out, int n) {
  ACC_TYPE acc = ACC_INIT;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc = ACC_STEP;
  out[threadIdx.x] = ACC_OUT;
}
"""


def _sum_spec(tmp_path, acc_type, init, step, out, template=None):
    src = (SUM_KERNEL.replace("ACC_TYPE", acc_type)
           .replace("ACC_INIT", init).replace("ACC_STEP", step)
           .replace("ACC_OUT", out))
    path = tmp_path / "sum_kernel.cu"
    path.write_text(src)
    ops_ = (build.Operand("x", (1024,), (256,), "bfloat16"),
            build.Operand("out", (256,), (256,), "bfloat16"))
    return build.LaunchSpec(kernel="sum", source=path, function="sum_kernel",
                            grid=(1, 1, 1), threads=256, smem=0,
                            operands=ops_, accumulator="acc",
                            template=template or {})


@pytest.mark.parametrize("acc_type,init,step,out,template,fires", [
    ("__nv_bfloat16", "__float2bfloat16(0.f)", "__hadd(acc, x[i])", "acc",
     None, True),
    ("float", "0.f", "acc + __bfloat162float(x[i])",
     "__float2bfloat16(acc)", None, False),
    ("float", "0.f", "fmaf(__bfloat162float(x[i]), 2.f, acc)",
     "__float2bfloat16(acc)", None, False),
    ("T", "T(0)", "acc + T(x[i])", "acc", {"T": "bfloat16"}, True),
    ("T", "T(0)", "acc + T(x[i])", "acc", {"T": "float32"}, False),
])
def test_low_precision_accumulate_reads_the_source(tmp_path, acc_type, init,
                                                   step, out, template,
                                                   fires):
    spec = _sum_spec(tmp_path, acc_type, init, step, out, template)
    got = _classes(KernelTileLint().check(Target(launches=(spec,))))
    assert ("low-precision-accumulate" in got) == fires
    assert "pack-pairing-drift" not in got   # acc is summed in the source


ASM_KERNEL = """
#include <cuda_bf16.h>
__device__ __forceinline__ void mma(ACC_TYPE (&d)[2], unsigned a) {
  asm volatile("mma %0, %1, %2;" : "+f"(d[0]), "+f"(d[1]) : "r"(a));
}
__global__ void asm_kernel(const __nv_bfloat16* __restrict__ x,
                           __nv_bfloat16* __restrict__ out, int n) {
  ACC_TYPE o[2];
  for (int i = 0; i < n; ++i) mma(o, i);
  out[threadIdx.x] = o[0];
}
"""


@pytest.mark.parametrize("acc_type,fires", [("float", False),
                                            ("__nv_bfloat16", True)])
def test_accumulator_updated_through_asm_operands(tmp_path, acc_type, fires):
    """An array a ``__device__`` helper updates through read-write ``asm``
    operands (a ``wgmma`` accumulator) is an accumulation: the spec may
    name it, and a 16-bit one fires."""
    path = tmp_path / "asm_kernel.cu"
    path.write_text(ASM_KERNEL.replace("ACC_TYPE", acc_type))
    ops_ = (build.Operand("x", (1024,), (256,), "bfloat16"),
            build.Operand("out", (256,), (256,), "bfloat16"))
    spec = build.LaunchSpec(kernel="asm", source=path, function="asm_kernel",
                            grid=(1, 1, 1), threads=256, smem=0,
                            operands=ops_, accumulator="o")
    got = _classes(KernelTileLint().check(Target(launches=(spec,))))
    assert ("low-precision-accumulate" in got) == fires
    assert "pack-pairing-drift" not in got


HELPER_KERNEL = """
#include <cuda_bf16.h>
template <typename T>
__device__ __forceinline__ void sum_into(const __nv_bfloat16* x, int n,
                                         __nv_bfloat16* out) {
  ACC_TYPE acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    acc = __fadd_rn(acc, __bfloat162float(x[i]));
  out[threadIdx.x] = acc;
}
template <typename T>
__device__ __forceinline__ void walk(const __nv_bfloat16* x, int n,
                                     __nv_bfloat16* out) {
  sum_into<T>(x, n, out);
}
__global__ void helper_kernel(const __nv_bfloat16* __restrict__ x,
                              __nv_bfloat16* __restrict__ out, int n) {
  walk<float>(x, n, out);
}
"""


@pytest.mark.parametrize("acc_type,fires", [("float", False),
                                            ("__nv_bfloat16", True)])
def test_accumulator_in_a_called_helper(tmp_path, acc_type, fires):
    """A kernel that sums in a ``__device__`` helper it calls (here two
    calls deep, through templates) sums there: the spec may name the
    helper's accumulator, and a 16-bit one fires."""
    path = tmp_path / "helper_kernel.cu"
    path.write_text(HELPER_KERNEL.replace("ACC_TYPE", acc_type))
    ops_ = (build.Operand("x", (1024,), (256,), "bfloat16"),
            build.Operand("out", (256,), (256,), "bfloat16"))
    spec = build.LaunchSpec(kernel="helper", source=path,
                            function="helper_kernel", grid=(1, 1, 1),
                            threads=256, smem=0, operands=ops_,
                            accumulator="acc")
    got = _classes(KernelTileLint().check(Target(launches=(spec,))))
    assert ("low-precision-accumulate" in got) == fires
    assert "pack-pairing-drift" not in got


def test_spec_naming_an_unsummed_accumulator_drifts(tmp_path):
    spec = dataclasses.replace(
        _sum_spec(tmp_path, "float", "0.f", "acc + 1.f", "acc"),
        accumulator="total")
    assert "pack-pairing-drift" in _classes(
        KernelTileLint().check(Target(launches=(spec,))))


def _case(label):
    return dict(ops.kernel_lint_cases())[label]


@pytest.mark.parametrize("label,change", [
    ("flash_attention[D64]", {"threads": 256}),
    ("flash_attention[D64]", {"constants": {"kFaThreads": 128,
                                            "kFaRows": 64, "kFaKeys": 64,
                                            "kFaLanes": 8}}),
    ("flash_attention[D256]", {"constants": {"kFaThreads": 128,
                                             "kFaRows": 128, "kFaKeys": 32,
                                             "kFaLanes": 8}}),
    ("flash_decode[rg]", {"threads": 256}),
    ("flash_decode[rg]", {"constants": {"kFdThreads": 128, "kFdRows": 16,
                                        "kFdTile": 64}}),
    ("flash_decode[lm100m]", {"accumulator": "acc_f32"}),
    ("flash_decode_combine[rg]", {"threads": 128}),
    ("flash_decode_combine[lm100m]", {"function": "flash_combine_kernel"}),
    ("flash_prefill[D64]", {"threads": 256}),
    ("flash_prefill[D256]", {"constants": {"kFpThreads": 128,
                                           "kFpRows": 128, "kFpKeys": 64}}),
    ("flash_prefill[D256]", {"accumulator": "acc"}),
    ("wkv6", {"threads": 128}),
    ("rglru", {"threads": 64, "constants": {"kLruChannels": 64,
                                            "kLruSteps": 32,
                                            "kLruStages": 4}}),
    ("pack_int4", {"constants": {"kBlock": 256, "kHalf": 64,
                                 "kThreads": 256}}),
    ("pack_int4[wq]", {"constants": {"kPackUnroll": 8}}),
    ("pack_int4[wq]", {"constants": {"kSlotBytes": 8, "kTileSlots": 2048}}),
    ("unpack_int4[wq]", {"constants": {"kPackBlocksPerSm": 8}}),
    ("unpack_int4[wq]", {"constants": {"kPackLeaves": 64}}),
    ("unpack_int4", {"threads": 128}),
    ("unpack_int4", {"function": "unpack_int4_tiles"}),
    ("dequant_merge", {"function": "no_such_kernel"}),
    ("dequant_merge", {"threads": 128}),
    ("dequant_merge_packed[wq]", {"constants": {"kColPairs": 16,
                                                "kColWidth": 256}}),
    ("dequant_merge_packed", {"constants": {"kRowUnits": 64}}),
    ("dequant_merge[wq]", {"constants": {"kMergeBlocksPerSm": 8}}),
])
def test_spec_out_of_step_with_its_source_drifts(label, change):
    spec = dataclasses.replace(_case(label), **change)
    assert "pack-pairing-drift" in _classes(
        KernelTileLint().check(Target(launches=(spec,))))


def test_python_pack_constants_drift(monkeypatch):
    assert analyze([KernelTileLint(check_constants=True)]).ok
    monkeypatch.setattr(pack, "HALF", 64)
    with pytest.raises(AnalysisError) as e:
        analyze([KernelTileLint(check_constants=True)], label="drift")
    assert _classes(e.value.violations) == {"pack-pairing-drift"}


@pytest.mark.parametrize("label", [label for label, _ in
                                   ops.kernel_lint_cases()])
def test_every_ported_kernel_lints_clean(label):
    spec = _case(label)
    assert spec.kernel in build.LAUNCHES
    assert analyze([KernelTileLint()], launches=[spec], label=label).ok


@pytest.mark.parametrize("dims,dtype", [
    *((dims, "float32") for dims in fa.HEAD_DIMS),
    *((dims, "bfloat16") for dims in fa.HEAD_DIMS if dims[0] < 64)])
def test_simt_launch_spec_lints_clean_and_fits(dims, dtype):
    """Every launch of the SIMT kernel (fp32 prefill at each pair of head
    dims, bf16 prefill below D 64) lints clean against the source's
    constants and fits the 232,448 bytes of shared memory a block may
    take, at recurrentgemma-2b's 2560 keys; the fp32 head dims up to 128
    leave room for two blocks an SM."""
    D, Dv = dims
    spec = fa.launch_spec((4, 512, 10, D), (4, 2560, 2, D), dtype, Dv)
    assert spec.kernel == "flash_simt"
    assert analyze([KernelTileLint()], launches=[spec],
                   label=f"flash_simt[{D}/{Dv} {dtype}]").ok
    assert spec.smem <= 232448
    if dtype == "float32" and D <= 128:
        assert 2 * (spec.smem + 1024) <= 233472


def test_lint_cases_cover_every_kernel_and_repeat_their_launchers():
    kernels = {spec.kernel for _, spec in ops.kernel_lint_cases()}
    assert kernels | {"tile_copy"} | set(build.WRAPPERS) == \
        set(build.LAUNCHES)
    # fa_smem_bytes<float, 256, 256>(4) (csrc/model_kernels.cu): the SIMT
    # kernel keeps fp32 prefill, its 64-row q tile, its 32-key K and V ring
    # in two stages and a flag a KV tile; its q tiles on the grid's
    # slowest axis
    assert _case("flash_attention[D256]").smem == \
        4 * 64 * (260 + 36) + 2 * 32 * 520 * 4 + 16
    assert fa.launch_spec((2, 20, 10, 256), (2, 20, 1, 256)).grid == \
        (10, 2, 1)
    # twice the rows (and threads) only where a 64-row block would hold its
    # SM alone and the taller one fits: fp32 at MLA's 192 / 128
    assert [fa.simt_rows(D, "float32", dv) for D, dv in fa.HEAD_DIMS] == \
        [64, 64, 64, 64, 64, 64, 128]
    assert _case("flash_attention[D192/128]").threads == 256
    # decode: one block per (split, KV head x row group, batch); 64 splits
    # of one 32-key tile at recurrentgemma-2b (4 x 64 = 256 blocks), 10
    # of two at lm100m's 577 slots (8 x 4 x 10 = 320); fd_smem_bytes<T, D>
    assert fa.decode_plan(4, 1, 10, 1, 2048) == (1, 1, 64)
    assert fa.decode_plan(8, 1, 12, 4, 577) == (1, 2, 10)
    assert fa.decode_plan(1, 16, 10, 1, 200) == (10, 1, 7)
    rg = _case("flash_decode[rg]")
    assert rg.grid == (64, 1, 4) and rg.threads == 128
    assert rg.smem == 2 * 32 * 256 * 2 + 32 * 16 + 4 * (16 * 32 + 64 + 34)
    assert fa.launch_spec((2, 1, 10, 256), (2, 2048, 1, 256)).grid == \
        (64, 1, 2)
    # the combine: a block per output row (b, sq, h); the splits' weights,
    # the split groups' sums and the warps' partials in shared memory
    assert _case("flash_decode_combine[rg]").grid == (40, 1, 1)
    assert _case("flash_decode_combine[lm100m]").grid == (96, 1, 1)
    assert _case("flash_decode_combine[rg]").smem == 4 * (64 + 1024 + 16)
    # the wgmma prefill: Q, K, V bf16 tiles of 64 x D, 1024 bytes to align
    # the swizzle atoms, an int per key tile; 96 KB at D 256 (two blocks
    # an SM)
    assert _case("flash_prefill[D256]").smem == 3 * 64 * 256 * 2 + 1024 + 8
    assert fa.prefill_smem(256, 2560) == 99328 + 4 * 40
    assert fa.launch_spec((4, 2560, 10, 256), (4, 2560, 1, 256),
                          "bfloat16").grid == (40, 10, 4)
    assert fa.design(150, 256, torch.bfloat16) == "flash_prefill"
    assert fa.design(150, 32, "bfloat16") == "flash_simt"
    assert fa.design(150, 256, torch.float32) == "flash_simt"
    assert fa.design(16, 256, torch.bfloat16) == "flash_decode"
    assert build.grid_for(10 ** 9) == 132 * 16
    # the merges: a persistent grid over the tiles (column tiles of wq: 2
    # layers x 3 blocks x 4 row groups x 3 column chunks), w2 and the
    # column tiles' scales in shared memory
    assert _case("dequant_merge_packed[wq]").grid == (72, 1, 1)
    assert _case("dequant_merge[wq]").smem == 4 * 4 * (1 + 256)
    assert _case("dequant_merge").grid == (1, 1, 1)
    assert _case("dequant_merge").smem == 4 * 2
    assert _case("quantize_int8").grid == (1, 1, 1)   # 8 blocks, 8 warps
    # pack and unpack: a persistent grid over tiles of 1024 16-byte slots
    # (wq at 2 layers: 24 units of 6144 slots), no shared memory
    assert _case("pack_int4[wq]").grid == (144, 1, 1)
    assert _case("unpack_int4[wq]").grid == (144, 1, 1)
    assert _case("pack_int4").grid == (1, 1, 1)
    assert _case("unpack_int4[wq]").smem == 0


# ---------------------------------------------------------------------------
# host-sync-in-loop: parity with the reference's RetraceGuard
# ---------------------------------------------------------------------------

def _bad_round_loop(rounds, any_push):
    pushed = 0
    for _ in range(rounds):
        if bool(any_push):          # a per-round host sync
            pushed += 1
    return pushed


def _good_round_loop(rounds, any_push):
    pushed = 0
    for _ in range(rounds):
        flag = _host_fetch(any_push)
        if bool(flag):
            pushed += 1
    return pushed


def _host_fetch(x):
    return bool(x)


def _item_in_loop(xs):
    total = 0.0
    for x in xs:
        total += x.item()
    return total


def _cpu_in_loop(xs):
    out = []
    for x in xs:
        out.append(x.cpu())
    return out


def _synchronize_in_loop(xs):
    for x in xs:
        x.add_(1)
        torch.cuda.synchronize()
    return xs


def _raised(thunk, error):
    """The violation classes ``thunk`` raises with ``error`` (none: set())."""
    try:
        thunk()
    except error as e:
        return _classes(e.violations)
    return set()


@pytest.mark.parametrize("fn,allow", [
    (_bad_round_loop, ("_host_fetch",)),
    (_item_in_loop, ("_host_fetch",)),
    (_good_round_loop, ("_host_fetch",)),
])
def test_host_sync_parity_with_retrace_guard(fn, allow):
    want = _raised(lambda: janalyze(
        None, rules=[RetraceGuard(check_args=False, allow=allow)], fn=fn,
        label="ref"), JAnalysisError)
    got = _raised(lambda: analyze([HostSyncGuard(allow=allow)], fn=fn,
                                  label="port"), AnalysisError)
    assert got == want
    assert got == (set() if fn is _good_round_loop
                   else {"host-sync-in-loop"})


@pytest.mark.parametrize("fn", [_cpu_in_loop, _synchronize_in_loop])
def test_host_sync_guard_flags_torch_surface(fn):
    with pytest.raises(AnalysisError) as e:
        analyze([HostSyncGuard()], fn=fn)
    assert _classes(e.value.violations) == {"host-sync-in-loop"}


def _old_train_loop(steps, hcfg, batch_iters, dev, pod_params, pod_opt, gup,
                    w_global, L_global, error, noise, log_every):
    """The round loop as it stood before the loop was made sync-free (a
    copy, never run: the guard reads its source)."""
    rounds, merges = 0, 0
    dispatched, committed = 0, 0
    pending = None
    history = []
    step_s, round_s = 0.0, 0.0
    for i in range(steps):
        stacked = {k: torch.stack([next(b)[k] for b in batch_iters]).to(dev)
                   for k in ("tokens", "targets")}
        t0 = time.perf_counter()                                # noqa: F821
        with torch.profiler.record_function("hermes/pod_step"):
            losses, grads = pod_losses_and_grads(               # noqa: F821
                pod_params, stacked)
            with torch.no_grad():
                pod_params, pod_opt = optimizer.apply(          # noqa: F821
                    pod_params, grads, pod_opt)
            del grads
            _sync(dev)                                          # noqa: F821
        step_s += time.perf_counter() - t0                      # noqa: F821
        if (i + 1) % hcfg.lam == 0 or i == 0:
            t0 = time.perf_counter()                            # noqa: F821
            rounds += 1
            with torch.profiler.record_function("hermes/round"), \
                    torch.no_grad():
                pod_losses = pod_eval(pod_params)               # noqa: F821
                if hcfg.async_rounds:
                    if pending is not None:
                        pod_params, w_global, L_global, opened = \
                            commit(pod_params, w_global,        # noqa: F821
                                   L_global, pending)
                        pending = None
                        merges += opened
                        committed += opened
                    out = hermes_dispatch(                      # noqa: F821
                        pod_params, gup, pod_losses, w_global, L_global,
                        hcfg, error=error, round_step=i, noise=noise)
                    pending = out["pending"]
                    dispatched += int(bool(out["any_push"]))
                else:
                    out = hermes_round(                         # noqa: F821
                        pod_params, gup, pod_losses, w_global, L_global,
                        hcfg, error=error, round_step=i, noise=noise)
                    pod_params, w_global = out["pod_params"], out["w_global"]
                    if bool(out["any_push"]):
                        merges += 1
                        L_global = eval_global(w_global)        # noqa: F821
                gup, error = out["gup"], out["error"]
                history.append((i + 1, float(torch.mean(pod_losses)),
                                int(out["gates"].sum())))
                _sync(dev)                                      # noqa: F821
            round_s += time.perf_counter() - t0                 # noqa: F821
        if (i + 1) % log_every == 0:
            print(f"step {i + 1:5d} pod-loss {float(losses.mean()):.4f} "
                  f"global-L {float(L_global):.4f} merges={merges}/{rounds}")
    return history


def test_round_loop_passes_and_the_old_loop_fails():
    assert analyze([HostSyncGuard(allow=("_host_fetch",))],
                   fn=ttrain.train_hermes, label="train_hermes").ok
    with pytest.raises(AnalysisError) as e:
        analyze([HostSyncGuard(allow=("_host_fetch",))], fn=_old_train_loop)
    calls = sorted({v.detail["call"] for v in e.value.violations})
    assert calls == ["bool(...)", "float(...)", "int(...)"]
    assert len(e.value.violations) == 7


def test_round_loop_fetches_only_at_logs_and_after(monkeypatch):
    calls = {"n": 0}
    real = ttrain._host_fetch

    def counting_fetch(values):
        calls["n"] += 1
        return real(values)

    monkeypatch.setattr(ttrain, "_host_fetch", counting_fetch)
    run = dict(steps=9, batch=2, seq=16, pods=2, device="cpu",
               opt_cfg=OptimizerConfig(name="adamw", lr=3e-4),
               hcfg=HermesConfig(alpha=-1.3, beta=0.1, lam=3, eta=1.0))
    out = ttrain.train_hermes(ttrain._preset("lmtiny"), log_every=10 ** 6,
                              **run)
    assert calls["n"] == 1
    assert out["rounds"] == 4     # step 1 plus every lam-th of 9 steps
    assert out["merges"] == sum(1 for _, _, g in out["history"] if g > 0)
    assert all(isinstance(l, float) and isinstance(g, int)
               for _, l, g in out["history"])
    calls["n"] = 0
    ttrain.train_hermes(ttrain._preset("lmtiny"), log_every=3, **run)
    assert calls["n"] == 1 + 3    # three log lines + the final fetch


# ---------------------------------------------------------------------------
# the entry point, and the caches' device default
# ---------------------------------------------------------------------------

def test_analyze_self_test_cli_on_cpu(tmp_path):
    out = tmp_path / "lint.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), **CHILD_ENV)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.analyze", "--self-test",
         "--device", "cpu", "--out", str(out)], env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    record = json.loads(out.read_text())
    assert record["ok"] and record["device"] == "cpu"
    labels = [t["label"] for t in record["targets"]]
    assert "train_hermes[source]" in labels
    assert len([l for l in labels if l.startswith("kernel[")]) == \
        len(ops.kernel_lint_cases()) + 1
    assert {f["expected_class"] for f in record["self_test"]} == \
        {"fp32-model-crossing", "dropped-donation", "host-sync-in-loop",
         "tile-misaligned"}
    # the donation halves run: nothing waits for another slice
    assert "waits" not in record
    rules = {t["label"]: t["rules"] for t in record["targets"]}
    assert [k for k, v in rules.items() if "donation-aliasing" in v] == \
        ["hermes_commit[int4]", "train_step[qwen3-8b]"]


def test_bad_tiles_selftest_on_cpu_lints_and_launches_nothing():
    build.reset_launches()
    out = selftest_bad_tiles(CPU)
    assert out["classes"] == ["tile-below-minimum", "tile-misaligned"]
    assert out["copy_equal"] is None
    assert build.LAUNCHES["tile_copy"] == 0


def _constructors():
    lmtiny = ttrain._preset("lmtiny")
    rwkv = get_smoke_config("rwkv6-3b")
    rg = get_smoke_config("recurrentgemma-2b")
    return [
        ("init_cache", lambda **kw: lm.init_cache(lmtiny, 1, 4, **kw)),
        ("init_kv_cache", lambda **kw: A.init_kv_cache(lmtiny, 1, 4, **kw)),
        ("init_rwkv_state", lambda **kw: R.init_rwkv_state(rwkv, 1, **kw)),
        ("init_rglru_state", lambda **kw: G.init_rglru_state(rg, 1, **kw)),
    ]


@pytest.mark.parametrize("name,make", _constructors())
def test_cache_constructors_default_to_the_card(name, make):
    from repro_torch.utils.trees import tree_leaves
    leaves = tree_leaves(make(device="cpu"))
    assert leaves and all(t.device.type == "cpu" for t in leaves)
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in tree_leaves(make()))
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            make()
