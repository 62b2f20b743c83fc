"""The grouped loss-weighted update (one launch updates every leaf of a
tree) on the CPU: its plain route against the per-leaf plain version and
the JAX reference, the rounds' use of it, and the tile walk the CUDA
kernel makes.

Inputs are made with numpy from a seed and handed to both sides.  The
tile walk is checked by repeating the kernel's assignment of elements to
tiles, slots and threads (``csrc/wire_kernels.cu``,
``loss_weighted_update_kernel``) in numpy: every element of every leaf
is written exactly once.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.config import HermesConfig
from repro_torch.core.gup import gup_gate
from repro_torch.dist import hermes_sync
from repro_torch.kernels import loss_weighted_update as lwu
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import placed_audit
from repro_torch.utils.trees import tree_leaves

from torch_parity import leaf_shapes
from torch_parity import to_numpy as _n
from torch_parity import to_torch as _t

EPS32 = np.float32(2.0 ** -23)

# 35 leaves (two launches a dtype past 32): whole slots, odd lengths, a
# 1-element leaf, a 0-d leaf, a middle-sized leaf; every third one bf16
SHAPES = [(4, 512), (3, 1000), (17,), (1,), (), (2, 768, 5), (7, 130),
          (64,), (5, 3, 3)] * 3 + [(9,), (4, 8), (300,), (2, 2), (33,),
                                   (1, 1, 1), (256,), (11, 3)]


def _tree(shapes, n_pods, seed, bf16_every=3):
    """Global leaves and pod-stacked models (numpy fp32) with each leaf's
    dtype, and the merge weights."""
    rng = np.random.default_rng(seed)
    gs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    pods = [(g[None] + 0.05 * rng.normal(size=(n_pods,) + tuple(s))).astype(
        np.float32) for g, s in zip(gs, shapes)]
    dtypes = [torch.bfloat16 if bf16_every and i % bf16_every == 2
              else torch.float32 for i in range(len(shapes))]
    w2 = (rng.uniform(0.2, 1.0, n_pods) * (np.arange(n_pods) != 1)).astype(
        np.float32)  # pod 1 closed
    w1 = np.float32(rng.uniform(0.1, 1.0))
    denom = np.float32(w1 + w2.sum(dtype=np.float32))
    return gs, pods, dtypes, w1, w2, denom


def _bf16_bits(x) -> np.ndarray:
    """bf16 values as their 16-bit patterns, ordered so that neighbouring
    values differ by one (sign-magnitude folded)."""
    t = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(torch.bfloat16)
    b = t.view(torch.int16).to(torch.int32).numpy()
    return np.where(b < 0, -(b & 0x7FFF), b)


@pytest.mark.parametrize("any_push", [True, False])
def test_grouped_update_plain_equals_per_leaf_and_reference(any_push):
    n_pods = 3
    gs, pods, dtypes, w1, w2, denom = _tree(SHAPES, n_pods, 7)
    leaves = [(_t(g).to(dt), _t(p).to(dt))
              for g, p, dt in zip(gs, pods, dtypes)]
    args = (torch.tensor(w1), _t(w2), torch.tensor(denom),
            torch.tensor(any_push))
    jargs = (jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(denom),
             jnp.asarray(any_push))
    got = tops.loss_weighted_update_group(leaves, *args)
    assert len(got) == len(leaves)
    for out, (g, p) in zip(got, leaves):
        assert out.dtype == g.dtype and out.shape == g.shape
        # the same function leaf by leaf: bitwise
        assert torch.equal(out, tref.loss_weighted_update_ref(g, p, *args))
        assert torch.equal(out, tops.loss_weighted_update(g, p, *args))
        if not any_push:
            assert torch.equal(out, g)
        jdt = jnp.bfloat16 if g.dtype == torch.bfloat16 else jnp.float32
        jg = jnp.asarray(_n(g.float())).astype(jdt)
        jp = jnp.asarray(_n(p.float())).astype(jdt)
        want = jref.loss_weighted_update_ref(jg, jp, *jargs)
        kern = jops.loss_weighted_update(jg, jp, *jargs)
        if g.dtype == torch.float32:
            # one rounding per operation in the same order: bitwise
            np.testing.assert_array_equal(_n(out), np.asarray(want))
            # the Pallas kernel may contract a multiply-add into an FMA
            # inside its compiled tile loop (tests/test_torch_wire.py
            # states the same bound): 2 ulps a pod of the largest term
            terms = (np.abs(w1 * _n(g)) + np.tensordot(
                w2, np.abs(_n(p)), 1)) / denom
            gap = np.abs(_n(out) - np.asarray(kern))
            assert np.all(gap <= 2 * EPS32 * (n_pods + 1) * terms
                          + 1e-30), float(gap.max())
        else:
            # bf16: an FMA contraction on either reference path moves the
            # fp32 sum by an ulp of fp32, which rounds to the same bf16 or,
            # at a rounding boundary, the next one
            # (tests/test_torch_bf16_merge.py states the same bound)
            for w in (want, kern):
                a = _bf16_bits(_n(out.float()))
                b = _bf16_bits(np.asarray(jnp.asarray(w, jnp.float32)))
                assert np.abs(a - b).max(initial=0) <= 1


def test_grouped_update_of_nothing_is_empty():
    one = torch.tensor(1.0)
    assert tops.loss_weighted_update_group([], one, torch.ones(2), one,
                                           torch.tensor(True)) == []


def _pods_tree(rng, n_pods, dtype):
    shapes = {"emb": (64, 32), "w": (32, 48), "b": (48,), "odd": (7, 3),
              "one": (1,), "s": ()}
    glob = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    pods = {k: (g[None] + 0.02 * rng.normal(size=(n_pods,) + g.shape))
            .astype(np.float32) for k, g in glob.items()}
    cast = {k: _t(v).to(dtype) for k, v in glob.items()}
    return cast, {k: _t(v).to(dtype) for k, v in pods.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compression", ["none", "fp16"])
def test_round_merges_in_one_group_as_before(compression, dtype,
                                             monkeypatch):
    """A ``none`` / ``fp16`` Hermes round on the kernel route hands every
    leaf to one grouped call (``fp16``: one a run of the decode fallback,
    whose reconstructions take at most the largest leaf's bytes at once),
    and its trees equal, bit for bit, the same round through the per-leaf
    ``loss_weighted_update`` calls the route made before the merge was
    grouped."""
    n_pods = 3
    w, pods = _pods_tree(np.random.default_rng(4), n_pods, dtype)
    cfg = HermesConfig(compression=compression)
    gup = hermes_sync.hermes_pod_state(cfg, n_pods, torch.device("cpu"))
    for level in (3.0, 3.2):
        _, gup = gup_gate(gup, torch.full((n_pods,), level), cfg)
    losses = torch.tensor([2.1, 2.2, 2.0])
    L = torch.tensor(3.4)

    def run():
        return hermes_sync.hermes_round(pods, gup, losses, w, L, cfg,
                                        use_kernel=True, round_step=1)

    calls = []
    real = tops.loss_weighted_update_group

    def spy(leaves, *a):
        calls.append(len(leaves))
        return real(leaves, *a)

    monkeypatch.setattr(tops, "loss_weighted_update_group", spy)
    got = run()
    # fp16 in key order: b, then emb (the largest) alone, then odd, one, s
    # and w (1,559 elements, under emb's 2,048)
    assert got["merged"] and calls == ([1, 1, 4] if compression == "fp16"
                                       else [6])

    def per_leaf(leaves, *a):
        return [tops.loss_weighted_update(g, p, *a) for g, p in leaves]

    monkeypatch.setattr(tops, "loss_weighted_update_group", per_leaf)
    want = run()
    for a, b in zip(tree_leaves([got["w_global"], got["pod_params"]]),
                    tree_leaves([want["w_global"], want["pod_params"]])):
        assert a.dtype == dtype and torch.equal(a, b)


def test_fallback_runs_hold_at_most_the_largest_leaf():
    assert hermes_sync.fallback_runs([]) == []
    assert hermes_sync.fallback_runs([5, 5, 1, 1, 3, 4]) == [
        [0], [1], [2, 3, 4], [5]]
    assert hermes_sync.fallback_runs([1, 2, 8, 3]) == [[0, 1], [2], [3]]
    # qwen3-8b at 1 layer: the embedding and the head alone, the rest
    # together
    qwen = [x.numel() * 2 * 2 for x in tree_leaves(placed_audit._w_global(
        {"preset": "qwen3-8b", "seed": 0, "layers": 1, "dtype": "bfloat16"},
        placed_audit.META))]
    assert hermes_sync.fallback_runs(qwen) == [[0], [1], list(range(2, 14))]


# ---------------------------------------------------------------------------
# the tile walk
# ---------------------------------------------------------------------------

def _covered(ns, itemsize, aligned=True):
    """How many times the kernel's walk writes each element of leaves of
    ``ns`` elements (one launch), each flat."""
    v = 16 // itemsize
    tiles = [lwu.tiles(n, itemsize) for n in ns]
    tile0 = np.concatenate([[0], np.cumsum(tiles)])
    hits = [np.zeros(n, dtype=np.int64) for n in ns]
    grid = lwu.grid(int(tile0[-1]))
    for b in range(grid):
        li = 0
        for t in range(b, int(tile0[-1]), grid):
            while li + 1 < len(ns) and t >= tile0[li + 1]:
                li += 1
            n = ns[li]
            s = ((t - tile0[li]) * lwu.TILE
                 + np.arange(lwu.SLOTS)[:, None] * 256 + np.arange(256))
            s = s.ravel()
            if aligned and n % v == 0:  # the vector path: whole slots
                s = s[s < n // v]
                e = (s[:, None] * v + np.arange(v)).ravel()
            else:
                e = (s[:, None] * v + np.arange(v)).ravel()
                e = e[e < n]
            np.add.at(hits[li], e, 1)
    return hits


@pytest.mark.parametrize("ns,itemsize", [
    ([2048], 4), ([1, 17, 3000, 4096, 1 << 14], 4), ([8, 9, 1, 70000], 2),
    ([5000, 4096 * 3 + 8], 2),
])
def test_tile_walk_writes_every_element_once(ns, itemsize):
    for aligned in (True, False):
        for n, h in zip(ns, _covered(ns, itemsize, aligned)):
            assert h.size == n and (h == 1).all(), (n, int(h.min()),
                                                    int(h.max()))


def test_tile_plan_of_lm100m_and_qwen3_8b_and_past_two_to_the_31():
    """lm100m x 4 pods (fp32) and qwen3-8b at 1 layer x 2 pods (bf16) are
    one launch each, on 32-bit offsets; a leaf whose pod stack reaches 2^31
    elements takes 64-bit ones.  Shapes only: nothing is allocated."""
    lm = [int(np.prod(s[1:])) for s in leaf_shapes("lm100m", 4)]
    qwen = [x.numel() for x in tree_leaves(placed_audit._w_global(
        {"preset": "qwen3-8b", "seed": 0, "layers": 1, "dtype": "bfloat16"},
        placed_audit.META))]
    for ns, pods, size in ((lm, 4, 4), (qwen, 2, 2)):
        assert len(ns) <= lwu.GROUP_LEAVES
        assert not lwu.wide(ns, pods)
        assert lwu.grid(sum(lwu.tiles(n, size) for n in ns)) == 132 * 4
    assert sum(lm) == 124_670_208
    assert lwu.wide([1 << 30], 2) and not lwu.wide([(1 << 30) - 1], 2)
    # 4 fp32 or 8 bf16 elements a slot, TILE slots a tile
    assert lwu.tiles(4 * lwu.TILE, 4) == 1
    assert lwu.tiles(4 * lwu.TILE + 1, 4) == 2
    assert lwu.tiles(8 * lwu.TILE, 2) == 1 and lwu.tiles(1, 2) == 1


def test_launch_specs_repeat_the_plan():
    spec = lwu.launch_spec((4, 512), 2)
    assert spec.grid == (2048 // (4 * lwu.TILE), 1, 1)
    assert spec.smem == 4 * 2
    ops_ = {o.name: o for o in spec.operands}
    assert ops_["g"].tile == (4 * lwu.TILE,)
    assert ops_["pods"].tile == (2, 4 * lwu.TILE)
    bf = lwu.launch_spec((1, 4096, 4096), 2, "bfloat16")
    assert bf.grid == (132 * 4, 1, 1)
    assert {o.name: o.tile for o in bf.operands}["out"] == (lwu.TILE * 8,)
