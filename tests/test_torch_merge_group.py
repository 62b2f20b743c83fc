"""The grouped merge (one launch merges every leaf of a tree) on the CPU:
its plain route against the per-leaf plain versions and the JAX
reference, the round's use of it, and the tile plan the CUDA kernels walk.

Inputs are made with numpy from a seed and handed to both sides.  The
tile plan is checked by repeating the kernels' assignment of outputs to
tiles, slots and lanes (``csrc/wire_kernels.cu``, ``merge_tiles`` and
``merge_slot``) in numpy: every output of every leaf is written exactly
once.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.dist import wire as jwire
from repro.kernels import ref as jref

from repro_torch.dist import hermes_sync
from repro_torch.dist import wire as twire
from repro_torch.kernels import dequant_merge as dqm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from torch_parity import leaf_shapes
from torch_parity import to_numpy as _n
from torch_parity import to_torch as _t

# a middle blocked axis whose inner extent is not a multiple of 4, a
# last-axis tail, lm100m's wq layout cut to 2 layers, and whole rows
MIXED = [(2, 512, 3), (3, 300), (2, 768, 12, 64), (4, 512), (12, 64), (700,)]


def _tree(shapes, n_pods, seed):
    """Global leaves, pod-stacked deltas and the merge weights (numpy)."""
    rng = np.random.default_rng(seed)
    gs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    deltas = [(0.05 * rng.normal(size=(n_pods,) + tuple(s))).astype(
        np.float32) for s in shapes]
    w2 = (rng.uniform(0.2, 1.0, n_pods) * (np.arange(n_pods) != 1)).astype(
        np.float32)  # pod 1 closed
    denom = np.float32(0.7 + w2.sum(dtype=np.float32))
    return gs, deltas, w2, denom


def _payloads(fmt_name, deltas):
    """The reference's wire payloads (numpy), so both sides merge the
    same bytes."""
    fmt = jwire.get_format(fmt_name)
    if fmt_name == "int4":
        return [{k: np.asarray(v) for k, v in fmt.encode(
            jnp.asarray(d), rng=jax.random.PRNGKey(i)).items()}
            for i, d in enumerate(deltas)]
    return [{k: np.asarray(v) for k, v in fmt.encode(jnp.asarray(d)).items()}
            for d in deltas]


CASES = [("lmtiny", None), ("mixed", MIXED)]


@pytest.mark.parametrize("tree,shapes", CASES)
@pytest.mark.parametrize("fmt_name", ["int4", "int8"])
@pytest.mark.parametrize("any_push", [True, False])
def test_grouped_merge_plain_equals_per_leaf_and_reference(tree, shapes,
                                                           fmt_name,
                                                           any_push):
    n_pods = 3
    if shapes is None:
        shapes = [s[1:] for s in leaf_shapes("lmtiny", n_pods)]
    gs, deltas, w2, denom = _tree(shapes, n_pods, len(shapes) + n_pods)
    pays = _payloads(fmt_name, deltas)
    key = "q_packed" if fmt_name == "int4" else "q"
    axes = [jwire.block_axis((n_pods,) + tuple(s)) for s in shapes]
    leaves = [(_t(g), _t(p[key]), _t(p["scales"]), ax)
              for g, p, ax in zip(gs, pays, axes)]
    args = (_t(w2), torch.tensor(denom), torch.tensor(any_push))
    group = (tops.dequant_merge_packed_group if fmt_name == "int4"
             else tops.dequant_merge_group)
    got = group(leaves, *args)
    plain = (tref.dequant_merge_packed_ref if fmt_name == "int4"
             else tref.dequant_merge_ref)
    jplain = (jref.dequant_merge_packed_ref if fmt_name == "int4"
              else jref.dequant_merge_ref)
    assert len(got) == len(leaves)
    for out, (g, q, sc, ax), p, gn in zip(got, leaves, pays, gs):
        assert torch.equal(out, plain(g, q, sc, *args, axis=ax))
        want = np.asarray(jplain(jnp.asarray(gn), jnp.asarray(p[key]),
                                 jnp.asarray(p["scales"]), jnp.asarray(w2),
                                 jnp.asarray(denom), jnp.asarray(any_push),
                                 axis=ax))
        if fmt_name == "int4":
            # one rounding per operation in the same order: bitwise
            np.testing.assert_array_equal(_n(out), want)
        else:
            # the reference's oracle sums the pods with a tensordot
            # (tests/test_torch_int8.py states the same 1e-5)
            np.testing.assert_allclose(_n(out), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fmt_name", ["int4", "int8"])
def test_round_merges_blocked_leaves_in_one_group(fmt_name, monkeypatch):
    """``_merge_payloads`` hands every leaf blocked off the pod axis to
    one grouped call, and leaves a 0-d leaf (stacked, it is blocked on the
    pod axis) to the decode-then-merge fallback; the result equals the
    per-leaf plain versions and the fallback bitwise."""
    n_pods = 3
    shapes = [(2, 512, 3), (3, 300), ()]
    gs, deltas, w2, denom = _tree(shapes, n_pods, 5)
    fmt = twire.get_format(fmt_name)
    noise = twire.GeneratorNoise(2, torch.device("cpu"))
    pays = [fmt.encode(_t(d), key=(0, i), noise=noise)
            for i, d in enumerate(deltas)]
    w_global = {f"l{i}": _t(g) for i, g in enumerate(gs)}
    payloads = {f"l{i}": p for i, p in enumerate(pays)}
    w1 = torch.tensor(np.float32(0.7))
    w2t, denom_t, push = _t(w2), torch.tensor(denom), torch.tensor(True)
    calls = []
    real = type(fmt).fused_merge_group

    def spy(self, gs_, pays_, *a):
        calls.append([tuple(g.shape) for g in gs_])
        return real(self, gs_, pays_, *a)

    monkeypatch.setattr(type(fmt), "fused_merge_group", spy)
    merged = hermes_sync._merge_payloads(w_global, payloads, w1, w2t,
                                         denom_t, push, fmt_name, True,
                                         n_pods)
    assert calls == [[(2, 512, 3), (3, 300)]]
    key = "q_packed" if fmt_name == "int4" else "q"
    plain = (tref.dequant_merge_packed_ref if fmt_name == "int4"
             else tref.dequant_merge_ref)
    for i in range(2):
        g, p = w_global[f"l{i}"], pays[i]
        ax = twire.block_axis((n_pods,) + tuple(g.shape))
        assert torch.equal(merged[f"l{i}"], plain(
            g, p[key], p["scales"], w2t, denom_t, push, axis=ax))
    g0 = w_global["l2"]
    recv = g0[None] + fmt.decode(pays[2], (n_pods,), g0.dtype)
    assert torch.equal(merged["l2"], hermes_sync._merge_leaf(
        g0, recv, w1, w2t, denom_t, push))


def test_grouped_merge_of_nothing_is_empty():
    w2 = torch.ones(2)
    assert tops.dequant_merge_group([], w2, torch.tensor(2.0),
                                    torch.tensor(True)) == []
    assert tops.dequant_merge_packed_group([], w2, torch.tensor(2.0),
                                           torch.tensor(True)) == []


# ---------------------------------------------------------------------------
# the tile plan
# ---------------------------------------------------------------------------

def _covered(plan: dqm.LeafPlan) -> np.ndarray:
    """How many times the kernels' tile walk writes each output of a leaf
    planned as ``plan`` (flat, in g's layout)."""
    o_, d, inner, nb = plan.outer, plan.d, plan.inner, plan.nb
    hits = np.zeros(o_ * d * inner, dtype=np.int64)
    m = np.arange(8)
    if plan.tc == 0:
        warps = 256 // 32
        t, s, w = np.meshgrid(np.arange(plan.tiles),
                              np.arange(dqm.ROW_UNITS // warps),
                              np.arange(warps), indexing="ij")
        u = (t * dqm.ROW_UNITS + s * warps + w).ravel()
        u = u[u < o_ * nb]
        o, b = u // nb, u % nb
        lane = np.arange(32)
        kk = (4 * lane[:, None] + (m >> 2) * 128 + (m & 3)).ravel()
        e = b[:, None] * 256 + kk[None, :]
        gi = o[:, None] * d + e
        np.add.at(hits, gi[e < d], 1)
        return hits
    tc, width = plan.tc, 4 * plan.tc
    chunks = -(-inner // width)
    t = np.arange(plan.tiles)
    cc, rest = t % chunks, t // chunks
    rg, ob = rest % (128 // dqm.COL_PAIRS), rest // (128 // dqm.COL_PAIRS)
    o, b = ob // nb, ob % nb
    r, c = np.divmod(np.arange(256), tc)
    steps = np.arange(dqm.COL_PAIRS // (256 // tc))
    j = (rg[:, None, None] * dqm.COL_PAIRS + r[None, :, None]
         + steps[None, None, :] * (256 // tc))                # (T, 256, S)
    i = (cc * width)[:, None] + 4 * c[None, :]                # (T, 256)
    kk = j[..., None] + (m >> 2) * 128                        # (T, 256, S, 8)
    ii = np.broadcast_to((i[:, :, None, None] + (m & 3)), kk.shape)
    e = b[:, None, None, None] * 256 + kk
    ok = (e < d) & (ii < inner) & (i < inner)[:, :, None, None]
    gi = ((o[:, None, None, None] * d + e) * inner + ii)[ok]
    np.add.at(hits, gi, 1)
    return hits


@pytest.mark.parametrize("g_shape,axis", [
    ((4, 512), 2), ((3, 300), 2), ((700,), 1), ((12, 64), 2),
    ((2, 768, 12, 64), 2), ((2, 768, 4, 64), 2), ((2, 512, 3), 2),
    ((3, 256, 5), 2), ((2, 512, 130), 2), ((1000, 256), 2), ((33, 768), 2),
])
def test_tile_plan_writes_every_output_once(g_shape, axis):
    plan = dqm.plan_leaf(g_shape, axis)
    assert (plan.outer, plan.d, plan.inner) == (
        math.prod(g_shape[:axis - 1]), g_shape[axis - 1],
        math.prod(g_shape[axis:]))
    hits = _covered(plan)
    assert hits.size == math.prod(g_shape)
    assert (hits == 1).all(), (int(hits.min()), int(hits.max()))


def test_tile_plan_of_lm100m_and_past_two_to_the_31():
    """lm100m x 4 pods fits 32-bit offsets, in one launch; a leaf whose
    pod-stacked payload passes 2^31 takes 64-bit ones.  Shapes only:
    nothing is allocated."""
    shapes = [s[1:] for s in leaf_shapes("lm100m", 4)]
    plans = [dqm.plan_leaf(s, twire.block_axis((4,) + s)) for s in shapes]
    assert len(plans) <= dqm.GROUP_LEAVES
    assert not dqm.wide(plans, 4)
    # wq (12, 768, 12, 64) and wk (12, 768, 4, 64): column tiles
    assert {(p.inner, p.tc) for p in plans if p.tc} == {(768, 64),
                                                        (256, 64)}
    assert dqm.grid(sum(p.tiles for p in plans)) == 132 * 4
    assert dqm.smem_bytes(plans, 4) == 4 * 4 * (1 + 256)
    # a 2^29-element leaf: 4 pods of int8 payload are 2^31 bytes
    big = dqm.plan_leaf((32768, 16384), 2)
    assert big.tc == 0 and big.tiles * dqm.ROW_UNITS == 32768 * 64
    assert dqm.wide([big], 4) and not dqm.wide([big], 3)
    col = dqm.plan_leaf((4096, 1024, 768), 2)   # column tiles past 2^31
    assert col.tc == 64 and dqm.wide([col], 1)
    assert col.tiles == 4096 * 4 * 4 * 3
    # the int4 payload of the same leaf is half as many bytes: 8 pods
    half = dqm.plan_leaf((32768, 16384), 2, prow=64 * 128)
    assert not dqm.wide([half], 4) and dqm.wide([half], 8)


def test_launch_specs_repeat_the_plan():
    spec = dqm.launch_spec("dequant_merge_packed", (2, 768, 12, 64), 4, 2)
    assert spec.grid == (2 * 3 * 4 * 3, 1, 1)
    assert spec.smem == 4 * 4 * (1 + dqm.COL_WIDTH)
    ops_ = {o.name: o for o in spec.operands}
    assert ops_["q_packed"].tile == (4, 1, dqm.COL_PAIRS, 256)
    row = dqm.launch_spec("dequant_merge", (4, 512), 2)
    assert row.grid == (1, 1, 1) and row.smem == 4 * 2
    assert {o.name: o.tile for o in row.operands}["q"] == (2, 8, 256)
    assert dqm.launch_spec("dequant_merge", (9216, 2048), 4).grid == \
        (132 * 4, 1, 1)
