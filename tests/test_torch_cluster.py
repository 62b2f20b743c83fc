"""The port's two-tier Hermes rounds (the reference's DESIGN.md section 10)
against ``repro.dist.hermes_sync`` on the CPU, unplaced.

Each reference pin of ``tests/test_cluster.py`` is held twice: inside the
port, bitwise (the one-cluster delegation, sync == dispatch + commit,
uneven == masked balanced, the whole-cluster drop), and the port against
the reference's own function on the same numpy inputs, within a few ulps
(XLA may contract ``acc + w*r`` into an FMA; ROADMAP, "FMA contraction").
The int4 dither is the reference's threefry draw on both tiers, the slow
tier's folded by 0x5C1.  The placed rounds are in
``tests/test_torch_placed.py``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import repro.dist.hermes_sync as jhs
from repro.config import HermesConfig as JHermesConfig
from repro.dist.wire import cluster_wire_operand_specs as j_cluster_specs
from repro.dist.wire import wire_operand_specs as j_specs
from repro.launch import mesh as jmesh

import repro_torch.dist.hermes_sync as ths
from repro_torch.config import HermesConfig
from repro_torch.dist import wire
from repro_torch.launch import mesh as tmesh
from repro_torch.utils.trees import tree_leaves, tree_map

from torch_parity import jax_noise, leaf_shapes
from torch_parity import to_numpy as _n

FORMATS = ("none", "fp16", "int8", "int4")
EPS32 = np.finfo(np.float32).eps
SHAPES = {"a": (8, 16), "b": (16,), "c": (3, 512)}
LOSSES = np.array([1.0, 2.0, 0.5, 3.0], np.float32)
L = np.float32(1.2)
SEED = 7


def _toy(seed, n_pods):
    rng = np.random.default_rng(seed)
    wg = {k: rng.normal(size=s).astype(np.float32)
          for k, s in SHAPES.items()}
    pods = {k: (g[None] + 0.01 * rng.normal(size=(n_pods,) + g.shape))
            .astype(np.float32) for k, g in wg.items()}
    return wg, pods


def _cfgs(mode, n_clusters):
    kw = dict(alpha=-0.5, beta=0.1, lam=2, window=4, compression=mode,
              error_feedback=mode in ("int8", "int4"), n_clusters=n_clusters)
    return JHermesConfig(**kw), HermesConfig(**kw)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _errs(mode, wg, n):
    if mode not in ("int8", "int4"):
        return None
    return {k: np.zeros((n,) + g.shape, np.float32) for k, g in wg.items()}


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _close(got, want, wg, pods):
    """Port against reference: a few fp32 ulps of the largest term an
    element sums (|g| and the largest |pod|), the tolerance of
    ``tests/test_torch_round.py``."""
    for gt, wt, g, p in zip(tree_leaves(got), jax.tree.leaves(want),
                            jax.tree.leaves(wg), jax.tree.leaves(pods)):
        scale = np.abs(g) + np.max(np.abs(p), axis=0)
        gap = np.abs(_n(gt) - np.asarray(wt))
        assert np.all(gap <= 8 * EPS32 * (scale + 1.0)), float(gap.max())


@pytest.fixture
def open_gates(monkeypatch):
    """Every GUP gate open, on both sides (each module imports the
    gate by name)."""
    monkeypatch.setattr(jhs, "gup_gate_jax",
                        lambda s, x, cfg: (jnp.asarray(True), s))
    monkeypatch.setattr(ths, "gup_gate",
                        lambda s, x, cfg: (torch.ones(x.shape[0],
                                                      dtype=torch.bool), s))


def _gups(jcfg, tcfg, n):
    return (jhs.hermes_pod_state(jcfg, n),
            ths.hermes_pod_state(tcfg, n, torch.device("cpu")))


# ---------------------------------------------------------------------------
# helpers: cluster count, row map, the layouts, the byte specs
# ---------------------------------------------------------------------------

def test_resolve_n_clusters_matches_reference():
    for kw in ({}, {"n_clusters": 2}, {"cluster_sizes": [2, 1, 1]}):
        for cfg_n in (1, 3):
            assert ths.resolve_n_clusters(HermesConfig(n_clusters=cfg_n),
                                          **kw) == \
                jhs.resolve_n_clusters(JHermesConfig(n_clusters=cfg_n), **kw)


def test_cluster_index_matches_reference():
    for args in ((6, 3), (4, 2, [3, 1]), (5, 2, [2, 3]), (4, 1)):
        np.testing.assert_array_equal(ths._cluster_index(*args),
                                      jhs._cluster_index(*args))
    for bad in ((5, 2), (4, 2, [4, 0])):
        with pytest.raises(AssertionError):
            ths._cluster_index(*bad)


def test_mesh_shapes_match_reference():
    for ndev, n_pods in ((512, 2), (8, 4), (8, 2), (5, 1), (16, 16)):
        assert tmesh.pod_mesh_shape(ndev, n_pods) == \
            jmesh.pod_mesh_shape(ndev, n_pods)
    for ndev, c, ppc in ((8, 2, 2), (16, 2, 4), (4, 4, 1)):
        assert tmesh.cluster_mesh_shape(ndev, c, ppc) == \
            jmesh.cluster_mesh_shape(ndev, c, ppc)
    with pytest.raises(AssertionError):
        tmesh.pod_mesh_shape(2, 4)


def test_rank_layout_is_cluster_major():
    """Cluster ``c`` owns a contiguous block of ranks (``make_pod_mesh``'s
    device order); the slow tier joins the ranks at one in-cluster
    index."""
    assert tmesh.rank_layout(4, 4, 2) == ([[0, 1], [2, 3]], [[0, 2], [1, 3]])
    assert tmesh.rank_layout(2, 4, 2) == ([[0], [1]], [[0, 1]])
    assert tmesh.rank_layout(4, 8) == ([[0, 1, 2, 3]], [[0], [1], [2], [3]])
    for bad in ((3, 4, 1), (4, 4, 3), (2, 6, 3)):
        with pytest.raises(ValueError):
            tmesh.rank_layout(*bad)
    g = tmesh.PodGroups(n_pods=8, rank=3, size=4, pod=None, n_clusters=2)
    assert (g.rows, g.cluster, g.rows_per_rank) == (slice(6, 8), 1, 2)
    assert tmesh.flatten_cluster_groups(g).group("cluster") == (None, 1)


def _hlo_to_torch(name):
    return {"f32": "float32", "f16": "float16", "s8": "int8"}[name]


@pytest.mark.parametrize("mode", FORMATS)
def test_wire_specs_match_reference(mode):
    """One pod row a rank: the port's gathered operands are the reference's
    (dims and bytes, dtype by name); the slow tier's are the specs at the
    cluster count, and never more bytes than the flat wire."""
    meta = {k: torch.empty(s, device="meta") for k, s in SHAPES.items()}
    abstract = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                            SHAPES, is_leaf=lambda s: isinstance(s, tuple))
    for got, want in ((wire.wire_operand_specs(meta, mode, 4),
                       j_specs(abstract, mode, 4)),
                      (wire.cluster_wire_operand_specs(meta, mode, 2),
                       j_cluster_specs(abstract, mode, 2))):
        assert got == [(_hlo_to_torch(d), dims, b) for d, dims, b in want]
    assert wire.cluster_wire_operand_specs(meta, mode, 2) == \
        wire.wire_operand_specs(meta, mode, 2)
    c_bytes = sum(b for *_, b in wire.cluster_wire_operand_specs(meta, mode,
                                                                 2))
    p_bytes = sum(b for *_, b in wire.wire_operand_specs(meta, mode, 8))
    assert c_bytes <= p_bytes
    # two pod rows a rank: each operand twice the rows and the bytes
    two = wire.wire_operand_specs(meta, mode, 4, rows=2)
    assert [(d, (2,) + dims[1:], 2 * b) for d, dims, b in
            wire.wire_operand_specs(meta, mode, 4)] == two


def test_wire_specs_of_a_scalar_leaf():
    """A stacked scalar is blocked on the pod axis (the reference's
    non-pinnable leaf): a placed round gathers its fp32 rows and encodes
    it whole on every rank, so its operand is the rows, and it crosses
    no slow tier."""
    meta = {"a": torch.empty((8, 16), device="meta"),
            "e": torch.empty((), device="meta")}
    specs = wire.wire_operand_specs(meta, "int8", 4)
    assert specs[0] == ("float32", (1,), 4)
    assert [s[1] for s in specs[1:]] == [(1, 8, 16), (1, 8, 1)]
    assert wire.cluster_wire_operand_specs(meta, "int8", 2) == specs[1:]
    assert wire.wire_operand_specs(meta, "none", 4)[0] == \
        ("float32", (1, 8, 16), 512)


@pytest.mark.parametrize("mode,fast,slow", [
    ("int4", 257_132_592, 128_566_296), ("int8", 506_473_008, 253_236_504)])
def test_lm100m_tier_bytes(mode, fast, slow):
    """At lm100m x 4 pods in 2 clusters, one pod row a rank: the fast tier
    moves the flat push's bytes, the slow tier half of them (one row a
    cluster, each a pod row's bytes)."""
    meta = [torch.empty(s[1:], device="meta")
            for s in leaf_shapes("lm100m", 4)]
    assert 4 * sum(b for *_, b in wire.wire_operand_specs(meta, mode, 4)) \
        == fast
    assert 2 * sum(b for *_, b in wire.cluster_wire_operand_specs(
        meta, mode, 2)) == slow
    assert wire.control_operand_spec(1) == ("float32", (1, 2), 8)


def test_generator_noise_fold_is_a_distinct_stream():
    base = wire.GeneratorNoise(3, torch.device("cpu"))
    a, b = base(0, 1, (4, 256)), base.fold(0x5C1)(0, 1, (4, 256))
    assert not torch.equal(a, b)
    assert torch.equal(b, base.fold(0x5C1)(0, 1, (4, 256)))


def test_row_noise_takes_rows_of_the_whole_draw():
    base = wire.GeneratorNoise(5, torch.device("cpu"))
    rows = wire.RowNoise(base, slice(2, 4), 4, whole={1})
    assert torch.equal(rows(3, 0, (2, 2, 256)), base(3, 0, (4, 2, 256))[2:4])
    assert torch.equal(rows(3, 1, (1, 256)), base(3, 1, (1, 256)))


# ---------------------------------------------------------------------------
# the reference's parity pins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", FORMATS)
def test_one_cluster_round_is_hermes_round(mode):
    """The delegation pin: at one cluster the two-tier round is
    ``hermes_round``, bitwise, and both match the reference's."""
    jcfg, tcfg = _cfgs(mode, 1)
    wg, pods = _toy(1, 4)
    err = _errs(mode, wg, 4)
    jgup, tgup = _gups(jcfg, tcfg, 4)
    # a loss history the next losses beat, so some gates open
    for level in (3.0, 3.2):
        x = np.full(4, level, np.float32)
        jgup = jax.vmap(lambda s, v: jhs.gup_gate_jax(s, v, jcfg))(
            jgup, jnp.asarray(x))[1]
        tgup = ths.gup_gate(tgup, torch.from_numpy(x), tcfg)[1]
    kw = dict(round_step=3, noise=jax_noise(SEED))
    a = ths.hermes_cluster_round(_t(pods), tgup, torch.from_numpy(LOSSES),
                                 _t(wg), torch.tensor(L), tcfg,
                                 error=None if err is None else _t(err), **kw)
    b = ths.hermes_round(_t(pods), tgup, torch.from_numpy(LOSSES), _t(wg),
                         torch.tensor(L), tcfg,
                         error=None if err is None else _t(err), **kw)
    for k in ("pod_params", "w_global", "gup", "error", "gates"):
        assert (a[k] is None and b[k] is None) or _equal(a[k], b[k]), k
    want = jhs.hermes_cluster_round(
        _j(pods), jgup, jnp.asarray(LOSSES), _j(wg), jnp.asarray(L),
        cfg=jcfg, error=None if err is None else _j(err),
        rng=jax.random.fold_in(jax.random.PRNGKey(SEED), 3))
    np.testing.assert_array_equal(_n(a["gates"]), np.asarray(want["gates"]))
    assert 0 < int(a["gates"].sum()) and a["merged"]
    _close(a["w_global"], want["w_global"], wg, pods)
    _close(a["pod_params"], want["pod_params"], wg, pods)


@pytest.mark.parametrize("mode", FORMATS)
def test_cluster_dispatch_commit_bit_identical_to_round(mode, open_gates):
    """The pipelined split: the sync two-tier round == dispatch + commit,
    bitwise, and both match the reference's round."""
    jcfg, tcfg = _cfgs(mode, 2)
    wg, pods = _toy(0, 4)
    err = _errs(mode, wg, 4)
    jgup, tgup = _gups(jcfg, tcfg, 4)
    args = (_t(pods), tgup, torch.from_numpy(LOSSES), _t(wg),
            torch.tensor(L), tcfg)
    kw = dict(error=None if err is None else _t(err), round_step=2,
              noise=jax_noise(SEED))
    sync = ths.hermes_cluster_round(*args, **kw)
    d = ths.hermes_cluster_dispatch(*args, **kw)
    assert "cluster_payload" in d["pending"]
    assert ths.pending_merges(d["pending"])
    c = ths.hermes_cluster_commit(_t(pods), d["pending"], _t(wg), cfg=tcfg)
    assert _equal([sync["pod_params"], sync["w_global"]],
                  [c["pod_params"], c["w_global"]])
    assert (sync["error"] is None and d["error"] is None) or \
        _equal(sync["error"], d["error"])
    want = jhs.hermes_cluster_round(
        _j(pods), jgup, jnp.asarray(LOSSES), _j(wg), jnp.asarray(L),
        cfg=jcfg, error=None if err is None else _j(err),
        rng=jax.random.fold_in(jax.random.PRNGKey(SEED), 2))
    _close(sync["w_global"], want["w_global"], wg, pods)
    _close(sync["pod_params"], want["pod_params"], wg, pods)
    if err is not None:
        _close(sync["error"], want["error"], wg, pods)
    # the whole wire, both tiers: every leaf moved
    assert all(float((x - y).abs().max()) > 0 for x, y in zip(
        tree_leaves(sync["w_global"]), tree_leaves(_t(wg))))


@pytest.mark.parametrize("mode", ("none", "fp16", "int8"))
def test_uneven_sizes_merge_equals_masked_balanced(mode):
    """A shrunk uneven [2, 1] merge over the survivors is bitwise the
    balanced (2, 2) merge with the dead pod's gate shut (the padded member
    grid adds exact zeros where the mask does), and matches the
    reference's.  int4 stays out, for the reference's reason: its dither
    is drawn over the whole leaf shape, so a 3-row and a 4-row pod-tier
    encode sample different bits."""
    wg, pods = _toy(2, 4)
    gates4 = np.array([True, True, True, False])
    full = ths.hermes_cluster_merge(
        _t(pods), torch.from_numpy(gates4), torch.from_numpy(LOSSES),
        _t(wg), torch.tensor(L), n_clusters=2, compression=mode)
    pods3 = {k: v[:3] for k, v in pods.items()}
    shr = ths.hermes_cluster_merge(
        _t(pods3), torch.from_numpy(gates4[:3]), torch.from_numpy(LOSSES[:3]),
        _t(wg), torch.tensor(L), n_clusters=2, cluster_sizes=[2, 1],
        compression=mode)
    assert _equal(full[1], shr[1])
    assert _equal({k: v[:3] for k, v in full[0].items()}, shr[0])
    want = jhs.hermes_cluster_merge(
        _j(pods3), jnp.asarray(gates4[:3]), jnp.asarray(LOSSES[:3]), _j(wg),
        jnp.asarray(L), n_clusters=2, cluster_sizes=[2, 1], compression=mode)
    _close(shr[1], want[1], wg, pods)
    _close(shr[0], want[0], wg, pods3)


def test_commit_drops_whole_cluster_of_dead_gated_member(open_gates):
    """Killing gated pod 3 at commit drops cluster 1 (pods 2 and 3) whole:
    bitwise a sync round whose live mask shut that cluster, pod 2 not
    refreshed; and the reference's commit agrees."""
    jcfg, tcfg = _cfgs("int8", 2)
    wg, pods = _toy(3, 4)
    err = _errs("int8", wg, 4)
    jgup, tgup = _gups(jcfg, tcfg, 4)
    args = (_t(pods), tgup, torch.from_numpy(LOSSES), _t(wg),
            torch.tensor(L), tcfg)
    d = ths.hermes_cluster_dispatch(*args, error=_t(err))
    live = torch.tensor([True, True, True, False])
    c = ths.hermes_cluster_commit(_t(pods), d["pending"], _t(wg), cfg=tcfg,
                                  live=live)
    oracle = ths.hermes_cluster_round(
        *args, error=_t(err), live=torch.tensor([True, True, False, False]))
    assert _equal([c["pod_params"], c["w_global"]],
                  [oracle["pod_params"], oracle["w_global"]])
    assert c["gates"].tolist() == [True, True, False, False]
    for k, v in c["pod_params"].items():
        assert torch.equal(v[2], torch.from_numpy(pods[k][2]))
    jd = jhs.hermes_cluster_dispatch(_j(pods), jgup, jnp.asarray(LOSSES),
                                     _j(wg), jnp.asarray(L), jcfg,
                                     error=_j(err))
    jc = jhs.hermes_cluster_commit(_j(pods), jd["pending"], _j(wg), cfg=jcfg,
                                   live=jnp.asarray(_n(live)))
    np.testing.assert_array_equal(_n(c["gates"]), np.asarray(jc["gates"]))
    _close(c["w_global"], jc["w_global"], wg, pods)
    _close(c["pod_params"], jc["pod_params"], wg, pods)


def test_closed_cluster_dispatch_commits_as_identity():
    """A first round never opens: the two-tier dispatch pends no payload,
    and its commit returns its inputs."""
    _, tcfg = _cfgs("int4", 2)
    wg, pods = _toy(4, 4)
    tgup = ths.hermes_pod_state(tcfg, 4, torch.device("cpu"))
    tp, tw = _t(pods), _t(wg)
    d = ths.hermes_cluster_dispatch(tp, tgup, torch.from_numpy(LOSSES), tw,
                                    torch.tensor(L), tcfg)
    assert d["pending"]["cluster_payload"] is None
    assert not ths.pending_merges(d["pending"])
    c = ths.hermes_cluster_commit(tp, d["pending"], tw, cfg=tcfg)
    assert c["pod_params"] is tp and c["w_global"] is tw
    assert not bool(c["any_push"])


def test_mask_cluster_rows_zeroes_only_dropped_rows():
    pay = {"q": torch.ones((2, 3, 4), dtype=torch.int8),
           "scales": torch.ones((2, 3, 1))}
    out = ths._mask_cluster_rows(pay, torch.tensor([True, False]), 2)
    assert bool((out["q"][0] == 1).all()) and bool((out["q"][1] == 0).all())
    assert bool((out["scales"][1] == 0).all())
    with pytest.raises(AssertionError):
        ths._mask_cluster_rows({"s": torch.ones(1)}, torch.tensor([True]), 2)


def test_uneven_sizes_refused_when_placed():
    """The reference's refusal: uneven clusters run unplaced only."""
    wg, pods = _toy(5, 3)
    groups = tmesh.PodGroups(n_pods=3, rank=0, size=3, pod=None,
                             n_clusters=1)
    with pytest.raises(ValueError, match="unplaced"):
        ths.hermes_cluster_merge(
            _t(pods), torch.ones(3, dtype=torch.bool),
            torch.from_numpy(LOSSES[:3]), _t(wg), torch.tensor(L),
            n_clusters=2, cluster_sizes=[2, 1], compression="int8",
            groups=groups)


@pytest.mark.parametrize("mode", FORMATS)
def test_flat_live_mask_matches_reference(mode, open_gates):
    """The flat halves' ``live`` mask (the elastic flush rule): a pod dead
    at commit weighs 0 and is not refreshed, bitwise the round whose live
    mask shut it before the merge; both match the reference's."""
    jcfg, tcfg = _cfgs(mode, 1)
    wg, pods = _toy(6, 4)
    err = _errs(mode, wg, 4)
    jgup, tgup = _gups(jcfg, tcfg, 4)
    live = np.array([True, True, True, False])
    kw = dict(error=None if err is None else _t(err), round_step=4,
              noise=jax_noise(SEED))
    args = (_t(pods), tgup, torch.from_numpy(LOSSES), _t(wg),
            torch.tensor(L), tcfg)
    d = ths.hermes_dispatch(*args, **kw)
    c = ths.hermes_commit(_t(pods), d["pending"], _t(wg), cfg=tcfg,
                          live=torch.from_numpy(live))
    r = ths.hermes_round(*args, live=torch.from_numpy(live), **kw)
    assert c["gates"].tolist() == r["gates"].tolist() == live.tolist()
    assert _equal([c["pod_params"], c["w_global"]],
                  [r["pod_params"], r["w_global"]])
    want = jhs.hermes_round(
        _j(pods), jgup, jnp.asarray(LOSSES), _j(wg), jnp.asarray(L), jcfg,
        error=None if err is None else _j(err), live=jnp.asarray(live),
        rng=jax.random.fold_in(jax.random.PRNGKey(SEED), 4))
    np.testing.assert_array_equal(_n(r["gates"]), np.asarray(want["gates"]))
    _close(r["w_global"], want["w_global"], wg, pods)
    _close(r["pod_params"], want["pod_params"], wg, pods)
