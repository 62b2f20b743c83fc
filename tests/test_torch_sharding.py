"""The port's sharding rule tables, the parameters' logical axes, the byte
bill's sharding hint and qwen3-8b's full-depth bills, against the JAX
reference, on the CPU.

The reference's production meshes are 512 devices; its rules read only a
mesh's axis names and sizes, so the reference is handed a stand-in with
those and the port its ``MeshShape``.  Every tree here is shapes alone:
the reference's through ``jax.eval_shape``, the port's on the ``meta``
device.
"""
import types

import numpy as np
import pytest
import jax

from repro.config import ParallelConfig as JParallel
from repro.configs import get_config as jget_config
from repro.dist import compression as jcomp
from repro.dist import wire as jwire
from repro.dist.sharding import make_rules as jmake_rules
from repro.dist.sharding import replica_axes as jreplica_axes
from repro.launch import mesh as jmesh
from repro.launch.steps import abstract_init_lm as jabstract

import torch_parity  # noqa: F401  (one torch thread)
import torch

from repro_torch.configs import _REGISTRY, get_config
from repro_torch.dist import compression as tcomp
from repro_torch.dist import sharding as tsh
from repro_torch.dist import wire as twire
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.steps import abstract_init_lm
from repro_torch.models.lm import param_axes
from repro_torch.utils.trees import tree_flatten, tree_map

ARCHS = sorted(_REGISTRY)
MESHES = {"single": False, "multi": True}
# activation axes the step builders name, beside every parameter's
ACTIVATIONS = [("batch", "seq", "act_embed"), ("batch", "seq", "act_ff"),
               ("batch", "seq", "act_heads", None),
               ("batch", "cache_seq", "act_kv", None),
               ("batch", "seq", "act_vocab"), ("moe_group", None, "embed"),
               ("seq", "act_ff", "seq")]
# qwen3-8b at full depth (36 layers, bf16 or fp32: the bill ignores it)
QWEN_BILLS = {"none": 32_762_941_440, "fp16": 16_381_470_720,
              "int8": 8_318_715_744, "int4": 4_223_348_064}


def _jmesh(shape):
    """The reference's mesh as its rules read it: axis names and sizes."""
    return types.SimpleNamespace(axis_names=shape.axis_names,
                                 devices=np.empty(shape.shape, np.int8))


_CACHE = {}


def _trees(arch):
    """``(reference shapes, reference axes, port meta tree, port axes)``."""
    if arch not in _CACHE:
        js, ja = jabstract(jget_config(arch), jax.random.PRNGKey(0))
        tp, ta = abstract_init_lm(get_config(arch))
        _CACHE[arch] = (js, ja, tp, ta)
    return _CACHE[arch]


def _jaxes(ja):
    return jax.tree.leaves(ja, is_leaf=lambda x: isinstance(x, tuple))


def _rules(arch, multi, decode, batch=256):
    shape = tmesh.make_production_mesh(multi_pod=multi)
    jm = jmesh.arch_rules(jget_config(arch), _jmesh(shape),
                          jmesh.arch_parallel_config(arch), multi_pod=multi,
                          decode=decode, batch=batch)
    tm = tmesh.arch_rules(get_config(arch), shape,
                          tmesh.arch_parallel_config(arch), multi_pod=multi,
                          decode=decode, batch=batch)
    return jm, tm


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_reference(arch):
    js, ja, tp, ta = _trees(arch)
    assert tree_flatten(ta)[0] == _jaxes(ja)
    assert tree_flatten(param_axes(get_config(arch)))[0] == _jaxes(ja)
    assert [tuple(x.shape) for x in tree_flatten(tp)[0]] == \
        [tuple(x.shape) for x in jax.tree.leaves(js)]
    assert all(x.device.type == "meta" for x in tree_flatten(tp)[0])


@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_rules_specs_equal_reference(arch, mesh, mode):
    """Every rule, and the spec of every parameter's and activation's
    axes, the reference's ``PartitionSpec`` as a tuple."""
    jr, tr = _rules(arch, MESHES[mesh], mode == "decode")
    assert tr.rules == jr.rules
    _, ja, _, ta = _trees(arch)
    for axes in tree_flatten(ta)[0] + ACTIVATIONS:
        assert tr.spec(axes) == tuple(jr.spec(axes)), axes
    specs = tree_flatten(tsh.param_sharding_tree(ta, tr))[0]
    assert specs == [tuple(jr.spec(a)) for a in _jaxes(ja)]


@pytest.mark.parametrize("arch", ARCHS)
def test_block_axis_hint_equals_reference(arch):
    """``block_axis`` of every leaf, alone and pod-stacked, with and
    without the hint, on both production meshes; the audit's claim that
    the hint moves no leaf's axis holds for every arch on the pod mesh."""
    js, ja, tp, ta = _trees(arch)
    shapes = [tuple(x.shape) for x in tree_flatten(tp)[0]]
    for multi in (False, True):
        jr, tr = _rules(arch, multi, False)
        for shape, axes in zip(shapes, tree_flatten(ta)[0]):
            for s, a in ((shape, axes), ((2,) + shape, (None,) + axes)):
                want = jwire.block_axis(s, axes=a, rules=jr)
                assert twire.block_axis(s, axes=a, rules=tr) == want, (s, a)
                assert twire.block_axis(s) == jwire.block_axis(s)


def test_rules_dedupe_and_replicate_like_reference():
    """First claim wins, a later claim degrades to replication, a tuple
    rule keeps its free members; the base table and the replica tiers."""
    table = {"a": "model", "b": "model", "c": ("pod", "data"),
             "d": ("data", "model")}
    tr, jr = tsh.AxisRules(dict(table)), jmake_rules(None, extra=table)
    for axes in [("a", "b"), ("c", "d"), ("d", "c"), (None, "a", "a"),
                 ("c", "c")]:
        assert tr.spec(axes) == tuple(tsh.AxisRules(dict(jr.rules))
                                      .spec(axes)) == tuple(jr.spec(axes))
    for kw in ({}, {"fsdp": True}, {"sequence_parallel": True}):
        assert tsh.make_rules(None, **kw).rules == jmake_rules(None, **kw).rules
    for multi in (False, True):
        shape = tmesh.make_production_mesh(multi_pod=multi)
        assert tsh.replica_axes(shape) == jreplica_axes(_jmesh(shape))
    assert tsh.replica_axes(None) == ()
    assert tsh.constrain("x", None, "batch") == "x"
    with pytest.raises(ValueError, match="no device mesh bound"):
        tsh.AxisRules({}).sharding(("batch",))
    assert tmesh.mesh_axis_size(tmesh.make_production_mesh(), "pod") == 1


@pytest.mark.parametrize("optimized", [False, True])
def test_parallel_configs_equal_reference(optimized):
    for arch in ARCHS:
        t = tmesh.arch_parallel_config(arch, optimized)
        j = jmesh.arch_parallel_config(arch, optimized)
        assert (t.fsdp, t.microbatch) == (j.fsdp, j.microbatch)
    assert (tsh.make_rules(None).rules.keys()
            == jmake_rules(None).rules.keys())
    t, j = tmesh.ParallelConfig(), JParallel()
    assert (t.sequence_parallel, t.expert_parallel, t.fsdp, t.zero1) == \
        (j.sequence_parallel, j.expert_parallel, j.fsdp, j.zero1)


@pytest.mark.parametrize("mode", list(QWEN_BILLS))
def test_qwen3_8b_full_depth_bills_equal_reference(mode):
    js, _, tp, _ = _trees("qwen3-8b")
    bf16 = tree_map(lambda x: torch.empty(x.shape, dtype=torch.bfloat16,
                                          device="meta"), tp)
    want = jcomp.payload_bytes(js, mode)
    assert want == QWEN_BILLS[mode]
    assert tcomp.payload_bytes(bf16, mode) == tcomp.payload_bytes(tp, mode) \
        == want
    # the wire specs of the fp32 twin are the bill; the bf16 tree's none
    # wire ships its own dtype
    specs = sum(s[2] for s in twire.wire_operand_specs(tp, mode, 2))
    assert specs == want
    bf = sum(s[2] for s in twire.wire_operand_specs(bf16, mode, 2))
    assert bf == (want // 2 if mode == "none" else want)


@pytest.mark.parametrize("mode", list(QWEN_BILLS))
@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b",
                                  "grok-1-314b"])
def test_payload_bytes_with_the_hint_equal_reference(arch, mode):
    js, ja, tp, ta = _trees(arch)
    for multi in (False, True):
        jr, tr = _rules(arch, multi, False)
        want = jcomp.payload_bytes(js, mode, param_axes=ja, rules=jr)
        assert tcomp.payload_bytes(tp, mode, param_axes=ta, rules=tr) == want


def test_a_hint_that_moves_the_axis_rebills():
    """A leaf whose rightmost whole-block axis shards out of alignment is
    blocked on the next one with the hint, and measured there: the memo
    is keyed on the resolved axis, as the reference's."""
    shape = tmesh.make_production_mesh(multi_pod=False)
    rules = tsh.make_rules(shape, extra={"vocab": "model"})
    jr = jmake_rules(_jmesh(shape), extra={"vocab": "model"})
    s, axes = (768, 4864), ("embed", "vocab")   # 4864 / 16 = 304: misaligned
    assert twire.block_axis(s, axes=axes, rules=rules) == 0 == \
        jwire.block_axis(s, axes=axes, rules=jr)
    assert twire.block_axis(s) == 1
    fmt = twire.get_format("int8")
    jfmt = jwire.get_format("int8")
    assert fmt.payload_bytes(s, axes=axes, rules=rules) == \
        jfmt.payload_bytes(s, axes=axes, rules=jr)
    assert fmt.payload_bytes(s) == jfmt.payload_bytes(s)
    # two whole-block axes bill the same bytes, measured twice
    assert {(s, 0), (s, 1)} <= set(fmt._measured_bytes)


def test_sharding_on_a_bound_device_mesh(tmp_path):
    """qwen3-8b's smoke model on a live (2, 4) (data, model) DeviceMesh of
    8 spawned gloo ranks, its rules bound (``AxisRules.bind``): every
    leaf's spec is the reference's ``arch_rules`` spec at batch 16, its
    ``.sharding`` placements are that spec's (``Shard(d)`` where the spec
    puts "model" on dimension ``d``, ``Replicate()`` on "data", which no
    parameter takes), a leaf placed with them keeps its slice and gathers
    back whole; ``constrain`` gives each rank its slice of a (16, 32)
    batch by the spec of ``("batch", "seq")`` (8 rows a data row, and the
    sequence over "model" as sequence parallelism puts it) and back, and
    is the identity with no device mesh bound."""
    from repro_torch.launch.spawn import spawn_ranks
    from repro.configs import get_smoke_config as jsmoke
    from repro_torch.configs import get_smoke_config
    import torch_ranks
    reports = spawn_ranks(8, {"shape": (2, 4)}, torch_ranks.mesh_placements,
                          timeout=300, workdir=str(tmp_path))
    shape = tsh.MeshShape(("data", "model"), (2, 4))
    jr = jmesh.arch_rules(jsmoke("qwen3-8b"), _jmesh(shape), JParallel(),
                          batch=16)
    _, ja = jabstract(jsmoke("qwen3-8b"), jax.random.PRNGKey(0))
    cfg = get_smoke_config("qwen3-8b")
    shapes = [tuple(x.shape) for x in tree_flatten(
        abstract_init_lm(cfg)[0])[0]]
    want = [tuple(jr.spec(a)) for a in _jaxes(ja)]
    assert any("model" in s for s in want)
    for rank, rep in enumerate(reports):
        assert len(rep["leaves"]) == len(want)
        for leaf, spec, full in zip(rep["leaves"], want, shapes):
            got = tuple(tuple(e) if isinstance(e, list) else e
                        for e in leaf["spec"])
            assert got == spec
            on = [d for d, e in enumerate(spec) if e == "model"]
            assert leaf["placements"] == leaf["direct"] == [
                "replicate", f"shard{on[0]}" if on else "replicate"]
            local = list(full)
            if on:
                local[on[0]] //= 4
            assert leaf["local"] == local and leaf["whole"]
        # the batch by its spec: rows over "data", and the sequence over
        # "model" under sequence parallelism
        batch = np.arange(16 * 32).reshape(16, 32)
        coord = {"data": rank // 4, "model": rank % 4}
        for d, e in enumerate(jr.spec(("batch", "seq"))):
            names = () if e is None else (e,) if isinstance(e, str) else e
            for name in names:
                n = batch.shape[d] // shape.axis_size(name)
                batch = np.take(batch, range(coord[name] * n,
                                             coord[name] * n + n), axis=d)
        assert rep["batch_local"] == batch.tolist()
        assert rep["batch_back"] and rep["identity"]
