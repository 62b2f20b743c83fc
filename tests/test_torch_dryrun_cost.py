"""The dry run's cost half on the CPU: ``analysis/cost.py``'s counter
against the reference's HLO cost walk, meta against CPU, the layer
repeat against the counted stack, the kernels' ``cost`` functions
against PERF.md's kernel table, the ``kernel`` route on ``meta``, and the
memory the counter tracks."""
import dataclasses
import functools
import re

import jax
import pytest
import torch
from jax.sharding import AxisType

import torch_parity  # noqa: F401  (one torch thread)

from repro.analysis.hlo_parse import parse_hlo_cost
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import ParallelConfig as JParallelConfig
from repro.config import ShapeConfig as JShapeConfig
from repro.configs import get_smoke_config as jsmoke
from repro.dist.sharding import make_rules
from repro.launch.steps import build_setup as jbuild_setup

from repro_torch.analysis.cost import StepCost, count_cost
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dist import wire
from repro_torch.kernels import dequant_merge as dqm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import loss_weighted_update as lwu
from repro_torch.kernels import ops
from repro_torch.kernels import pack, quantize, rglru_scan, rwkv6_scan
from repro_torch.kernels import tile_copy
from repro_torch.launch import dryrun as D
from repro_torch.launch.train import _preset
from repro_torch.models.lm import init_lm
from repro_torch.models.rwkv import DECAY_LORA
from repro_torch.utils.trees import tree_flatten

SEQ, BATCH = 64, 2


def smoke_shape(kind: str) -> ShapeConfig:
    return ShapeConfig("smoke", SEQ, BATCH, kind)


@functools.lru_cache(maxsize=None)
def reference(arch: str, kind: str):
    """The reference's step at the smoke config, compiled on a (1, 1)
    ("data", "model") mesh of Auto axes: its HLO cost and text."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with mesh:
        setup = jbuild_setup(kind, jsmoke(arch),
                             JShapeConfig("smoke", SEQ, BATCH, kind),
                             make_rules(mesh), JParallelConfig(),
                             JOptimizerConfig(name="adamw", lr=3e-4))
        compiled = jax.jit(setup.step_fn, in_shardings=setup.in_shardings,
                           out_shardings=setup.out_shardings).lower(
            *setup.abstract_args).compile()
    text = compiled.as_text()
    return parse_hlo_cost(text), text


@functools.lru_cache(maxsize=None)
def port(arch: str, kind: str, device: str = "meta", impl=None) -> StepCost:
    cell = D.make_cell(arch, smoke_shape(kind), cfg=get_smoke_config(arch),
                       device=device, impl=impl)
    return D.count_cell(cell)


# one (arch, kind) a family: dense, MoE + MLA, MoE, hybrid,
# encoder-decoder, vision
EQUAL = [("qwen3-8b", "train"), ("deepseek-v2-lite-16b", "prefill"),
         ("grok-1-314b", "decode"), ("recurrentgemma-2b", "train"),
         ("seamless-m4t-large-v2", "prefill"), ("llava-next-34b", "train")]


@pytest.mark.parametrize("arch,kind", EQUAL)
def test_counted_flops_equal_the_reference_hlo(arch, kind):
    ref, _ = reference(arch, kind)
    got = port(arch, kind)
    assert got.dot_flops + got.conv_flops == ref.dot_flops + ref.conv_flops
    assert got.flops == got.dot_flops + got.conv_flops


def rwkv_gap(kind: str, B: int = BATCH, T: int = SEQ) -> int:
    """The port's dot FLOPs less the reference's at rwkv6-smoke, from the
    two contraction orders (see the test below)."""
    cfg = get_smoke_config("rwkv6-3b")
    d, L, l = cfg.d_model, cfg.num_layers, DECAY_LORA
    H, hd, BT = cfg.num_heads, cfg.resolved_head_dim, B * T
    # decay = x (w1 w2): XLA contracts the weights first (2 d l d, then
    # 2 BT d d); the port x @ w1, then @ w2 (2 BT d l + 2 BT l d)
    fwd = 2 * BT * d * l + 2 * BT * l * d - (2 * d * l * d + 2 * BT * d * d)
    if kind == "prefill":
        return L * fwd
    # its backward: the port's four BT-row products against the
    # reference's two and the two weight products
    bwd = 8 * BT * d * l - (4 * BT * d * d + 4 * d * d * l)
    # the WKV step's backward: the reference's outer product k v^T
    # transposes into two dots (dk, dv) where the port's broadcast
    # multiply has none, and the read-out's state gradient r dy^T, a
    # batched matmul of inner dimension 1 in the port, is a multiply in
    # the reference: one 2 B H D^2 a step fewer in the port
    wkv = -2 * B * H * hd * hd * T
    return L * (fwd + bwd + wkv)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_rwkv6_gap_is_the_contraction_order(kind):
    """rwkv6-3b is the one family whose counts differ, by a closed form:
    the decay LoRA's ``einsum("btd,dl,le->bte")`` is contracted weights
    first by XLA (its HLO holds a (d, d) dot of that einsum), and the WKV
    step's outer products are multiplies or dots on opposite sides.  The
    read-out ``bhk,bhkv->bhv`` is a dot in the reference's HLO too, and
    counted there."""
    ref, text = reference("rwkv6-3b", kind)
    got = port("rwkv6-3b", kind)
    assert got.dot_flops - ref.dot_flops == rwkv_gap(kind)
    d = get_smoke_config("rwkv6-3b").d_model
    dots = [line for line in text.splitlines() if " dot(" in line]

    def shapes(einsum):
        return [re.search(r"= (\w+\[[\d,]*\])", line).group(1)
                for line in dots if f"/{einsum}/dot_general" in line]
    assert f"f32[{d},{d}]" in shapes("btd,dl,le->bte")
    assert shapes("bhk,bhkv->bhv")          # the read-out: a dot, counted
    if kind == "prefill":
        assert not shapes("bhk,bhv->bhkv")  # the outer product: a multiply


@pytest.mark.parametrize("arch,kind", [
    ("qwen3-8b", "train"), ("qwen3-8b", "prefill"), ("qwen3-8b", "decode"),
    ("deepseek-v2-lite-16b", "decode"), ("rwkv6-3b", "prefill"),
    ("recurrentgemma-2b", "decode"), ("seamless-m4t-large-v2", "decode"),
    ("llava-next-34b", "prefill")])
def test_meta_counts_equal_cpu_counts(arch, kind):
    """The same integers on ``meta`` and on CPU tensors: FLOPs, bytes and
    launches by op, and the memory."""
    meta, cpu = port(arch, kind), port(arch, kind, "cpu")
    assert meta.counts() == cpu.counts()
    assert meta.memory == cpu.memory


def _same(a: StepCost, b: StepCost) -> None:
    assert D._flat(a) == D._flat(b)


@pytest.mark.parametrize("arch", ["qwen3-8b", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2", "rwkv6-3b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_layer_repeat_equals_the_counted_stack(arch, kind):
    """At smoke width, four layers (five for the hybrid's pattern, three
    encoder layers): the count from the shallow depths, evaluated at the
    config's, is the layer-by-layer count, memory included."""
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=5 if cfg.is_hybrid else 4,
                              num_encoder_layers=3 if
                              cfg.is_encoder_decoder else 0)
    cell = D.make_cell(arch, smoke_shape(kind), cfg=cfg)
    rep, depths = D.count_by_repeat(cell)
    assert len(depths) == 3 if cfg.is_hybrid or cfg.is_encoder_decoder \
        else depths == [1, 2]
    _same(rep, D.count_cell(cell))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_layer_repeat_at_full_width(shape):
    """qwen3-8b at its published width, 3 layers, batch 1, a 1024-token
    sequence (the cells' lengths only multiply the tiles)."""
    s = dataclasses.replace(D.SHAPES[shape], seq_len=1024, global_batch=1)
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=3)
    cell = D.make_cell("qwen3-8b", s, cfg=cfg)
    _same(D.count_by_repeat(cell)[0], D.count_cell(cell))


def test_kernel_route_on_meta_charges_units_and_runs_no_plain(monkeypatch):
    """``impl="kernel"``: one ``kernel:<design>`` a layer, no op of the
    plain version (it is made to raise) on ``meta``; on CPU tensors the
    plain version runs uncharged and the counts are the same."""
    cfg = get_smoke_config("qwen3-8b")

    def count(kind, device):
        cell = D.make_cell("qwen3-8b", smoke_shape(kind), cfg=cfg,
                           device=device, impl="kernel")
        return D.count_cell(cell)

    cpu = {k: count(k, "cpu") for k in ("prefill", "decode")}

    def boom(*a, **k):
        raise AssertionError("the plain version ran on meta")
    monkeypatch.setattr(fa, "flash_attention_plain", boom)
    for kind, design in (("prefill", "flash_simt"),
                         ("decode", "flash_decode")):
        meta = count(kind, "meta")
        assert meta.launches_by_op[f"kernel:{design}"] == cfg.num_layers
        assert not any(k.startswith("kernel:") and k != f"kernel:{design}"
                       for k in meta.launches_by_op)
        assert meta.kernel_flops > 0
        assert meta.counts() == cpu[kind].counts()


def test_scan_kernel_entries_charge_once_on_meta_and_cpu():
    """WKV6 and the RG-LRU entries: one unit each with their module's
    ``cost``, the same on ``meta`` as on CPU tensors."""
    g = torch.Generator().manual_seed(0)
    B, T, H, Dh, W = 2, 8, 2, 16, 32

    def args(device):
        r, k, v = (torch.randn((B, T, H, Dh), generator=g) for _ in "rkv")
        log_w = -torch.rand((B, T, H, Dh), generator=g)
        a, b = torch.rand((B, T, W), generator=g), torch.randn(
            (B, T, W), generator=g)
        return [t.to(device) for t in (r, k, v, log_w, torch.zeros(H, Dh),
                                       torch.zeros(B, H, Dh, Dh), a, b)]

    def run(device):
        r, k, v, log_w, u, s, a, b = args(device)
        return count_cost(lambda: (ops.wkv6(r, k, v, log_w, u, s),
                                   ops.rglru(a, b)))[1]
    meta, cpu = run("meta"), run("cpu")
    assert meta.counts() == cpu.counts()
    assert meta.launches_by_op == {"kernel:wkv6": 1, "kernel:rglru": 1}
    assert meta.bytes_by_op["kernel:wkv6"] == rwkv6_scan.cost(
        (B, T, H, Dh), torch.float32)[1]
    assert meta.bytes_by_op["kernel:rglru"] == rglru_scan.cost(
        (B, T, W), h0=False)[1]


def test_visible_counts_equal_the_mask():
    g = torch.Generator().manual_seed(0)
    for _ in range(100):
        Sq, Skv = (int(torch.randint(1, 24, (), generator=g))
                   for _ in range(2))
        qp = torch.randint(0, 40, (Sq,), generator=g)
        kp = torch.randint(-1, 40, (Skv,), generator=g)
        for causal in (True, False):
            for window in (0, 1, 7):
                m = fa.visible(qp, kp, causal=causal,
                               window=window).expand(Sq, Skv)
                assert fa.visible_counts(qp, kp, causal=causal,
                                         window=window) == \
                    (int(m.sum()), int(m.any(0).sum()))


# -- the kernels' cost against PERF.md's kernel table ------------------------

H100_BPS = 3.35e12


def _ms(moved: int) -> float:
    return round(1e3 * moved / H100_BPS, 3)


def lm100m_tree():
    """The lm100m x 4-pod pass of rows 1-7, on ``meta`` tensors: the
    global leaves, the stacked deltas, their block axes and the int4 and
    int8 payloads."""
    g_leaves = tree_flatten(init_lm(_preset("lm100m"), 0, "meta"))[0]
    deltas = [torch.empty((4,) + tuple(x.shape), device="meta")
              for x in g_leaves]
    axes = [wire.block_axis(d.shape) for d in deltas]
    ids = [(0, i) for i in range(len(deltas))]
    int4 = wire.get_format("int4").encode_group(deltas, ids,
                                                wire._zero_noise)
    int8 = [wire.get_format("int8").encode(d) for d in deltas]
    return g_leaves, deltas, axes, int4, int8


def test_wire_kernel_costs_reproduce_rows_1_to_7():
    g, deltas, axes, int4, int8 = lm100m_tree()
    f32 = torch.float32
    rows = {
        1: pack.cost("pack_int4", [(d.shape, d.shape[ax], ax)
                                   for d, ax in zip(deltas, axes)]),
        2: pack.cost("unpack_int4", [(p["q_packed"].shape, d.shape[ax], ax)
                                     for p, d, ax in zip(int4, deltas,
                                                         axes)]),
        3: dqm.cost([(x.shape, f32, p["q_packed"].shape, p["scales"].shape)
                     for x, p in zip(g, int4)], 4),
        4: lwu.cost([(x.shape, f32, f32) for x in g], 4),
        5: dqm.cost([(x.shape, f32, p["q"].shape, p["scales"].shape)
                     for x, p in zip(g, int8)], 4),
    }
    for kernel, row in (("quantize_int8", 6), ("dequantize_int8", 7)):
        costs = [quantize.cost(kernel, d.shape) for d in deltas]
        rows[row] = tuple(map(sum, zip(*costs)))
    # (GB, bound ms) as the table states them
    table = {1: (0.748, 0.223), 2: (0.748, 0.223), 3: (1.254, 0.374),
             4: (2.992, 0.893), 5: (1.504, 0.449), 6: (2.501, 0.747),
             7: (2.501, 0.747)}
    for row, (gb, bound) in table.items():
        flops, moved = rows[row]
        assert round(moved / 1e9, 3) == gb, row
        # every wire row is bound by its bytes, on fp32's 67 TFLOP/s too
        assert flops / 67e12 < moved / H100_BPS
        assert _ms(moved) == bound, row


def test_model_kernel_costs_reproduce_rows_8_to_11():
    bf16, f32 = torch.bfloat16, torch.float32

    def flash(B, Sq, H, K, D, Dv, q0, kvpos, dtype, causal=True):
        qpos = torch.arange(q0, q0 + Sq)
        pairs, seen = fa.visible_counts(qpos, kvpos, causal=causal,
                                        window=0)
        return fa.cost((B, Sq, H, D), (B, kvpos.numel(), K, D), dtype, Dv,
                       pairs=pairs, seen=seen), pairs, seen

    def linear(slots, written):
        kp = torch.arange(slots)
        kp[written:] = -1
        return kp

    # row 8 prefill (lm100m, fp32): 3.228 GFLOP; the table's 34.6 MB
    # counts all 577 slots of k and v, 512 of them written and seen
    (flops, moved), pairs, seen = flash(8, 512, 12, 4, 64, 64, 0,
                                        linear(577, 512), f32)
    assert round(flops / 1e9, 3) == 3.228 and seen == 512
    assert round(moved / 1e6, 2) == 33.56
    every = fa.cost((8, 512, 12, 64), (8, 577, 4, 64), f32, pairs=pairs,
                    seen=577)[1]
    assert round(every / 1e6, 1) == 34.6
    # 8c: MLA D 192 / Dv 128, bf16, 1024 queries into a 1057-slot cache
    (flops, moved), _, _ = flash(4, 1024, 16, 16, 192, 128, 0,
                                 linear(1057, 1024), bf16)
    assert (round(moved / 1e6, 2), round(flops / 1e9, 3)) == (83.89, 21.496)
    # 8d: the encoder's non-causal D 64 prefill
    (flops, moved), _, _ = flash(4, 1024, 16, 16, 64, 64, 0,
                                 torch.arange(1024), bf16, causal=False)
    assert (round(moved / 1e6, 2), round(flops / 1e9, 3)) == (33.56, 17.180)
    # 8e: llava's G 7 at D 128
    (flops, moved), _, _ = flash(2, 1024, 56, 8, 128, 128, 0,
                                 torch.arange(1024), bf16)
    assert (round(moved / 1e6, 2), round(flops / 1e9, 3)) == (67.12, 30.094)
    # 9: WKV6 prefill at rwkv6-3b, one layer, B 4, T 256, 40 heads of 64
    flops, moved = rwkv6_scan.cost((4, 256, 40, 64), bf16)
    assert (round(moved / 1e6, 1), round(flops / 1e9, 3)) == (36.7, 1.174)
    # 10: the RG-LRU at recurrentgemma-2b, B 4, T 2560, W 2560
    flops, moved = rglru_scan.cost((4, 2560, 2560))
    assert (round(moved / 1e6, 2), round(flops / 1e6, 1)) == (314.65, 52.4)
    # 11: the fixture's copy
    assert tile_copy.cost() == (0, 128_000)


# -- memory --------------------------------------------------------------------

def test_donated_train_state_is_aliased():
    """The train step writes into its state: every state byte comes back
    as output storage (``alias``); a function that builds new tensors
    aliases nothing."""
    cell = D.make_cell("qwen3-8b", smoke_shape("train"),
                       cfg=get_smoke_config("qwen3-8b"))
    state = tree_flatten(cell.args[0]["params"])[0] + [
        t for k, v in cell.args[0]["opt"].items() if k != "step"
        for t in tree_flatten(v)[0]]
    state_bytes = sum(t.untyped_storage().nbytes() for t in state)
    mem = D.count_cell(cell).memory
    assert mem["alias_size_in_bytes"] == state_bytes
    assert mem["argument_size_in_bytes"] > state_bytes
    assert mem["temp_size_in_bytes"] > 0
    x = torch.empty((64, 64), device="meta")
    _, cost = count_cost(lambda x: x * 2, x, donate=(0,))
    assert cost.memory["alias_size_in_bytes"] == 0
    assert cost.memory["output_size_in_bytes"] == 64 * 64 * 4


@pytest.mark.parametrize("dtype,hlo", [
    (torch.bool, "pred"), (torch.int8, "s8"), (torch.bfloat16, "bf16"),
    (torch.float16, "f16"), (torch.int32, "s32"), (torch.float32, "f32"),
    (torch.int64, "s64"), (torch.float64, "f64")])
def test_shape_helpers_equal_the_reference(dtype, hlo):
    """``shape_bytes`` over ``(shape, dtype)`` and ``shape_dims`` over
    ``shape``, the reference's over an HLO type string, and a tensor's own
    bytes."""
    from repro.analysis.hlo_parse import shape_bytes as jshape_bytes
    from repro.analysis.hlo_parse import shape_dims as jshape_dims
    from repro_torch.analysis.cost import shape_bytes, shape_dims
    for shape in ((), (7,), (4, 8, 3)):
        text = f"{hlo}[{','.join(map(str, shape))}]"
        assert shape_bytes(shape, dtype) == jshape_bytes(text) == \
            torch.empty(shape, dtype=dtype, device="meta").nbytes
        assert shape_dims(shape) == jshape_dims(text)
