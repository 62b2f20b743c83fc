"""The port's elastic membership, shrink half (``repro_torch.launch.elastic``)
against ``repro.launch.elastic`` on the CPU: the reference's
``tests/test_elastic_membership.py``, each test fed the same numpy inputs
on both sides, plus the flush of ``tests/test_hermes_sync.py``.

Index moves (``shrink_pod_tree``, ``elastic_shrink``'s rows, the gate
state) are held bitwise against the reference.  A merged value is held
bitwise within the port (masked == reduced, as the reference pins it) and
against the reference within a few fp32 ulps of the largest term an
element sums (XLA may contract ``acc + w*r`` into an FMA; the tolerance
of ``tests/test_torch_round.py``).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.config import HermesConfig as JHermesConfig
from repro.core.allocator import Allocation as JAllocation
from repro.dist import hermes_sync as jhs
from repro.launch import elastic as jel

from repro_torch.config import HermesConfig
from repro_torch.core.allocator import Allocation
from repro_torch.dist import hermes_sync as ths
from repro_torch.launch import elastic as tel
from repro_torch.utils.trees import tree_leaves, tree_map

from torch_parity import to_numpy as _n

EPS32 = np.finfo(np.float32).eps
CPU = torch.device("cpu")


def _np_pods(seed, n, shape=(6, 5)):
    return {"w": np.random.default_rng(seed).normal(
        size=(n,) + shape).astype(np.float32)}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _cfgs(**kw):
    return JHermesConfig(**kw), HermesConfig(**kw)


def _bitwise(got, want):
    """Port tree against reference tree, bit for bit."""
    lg, lw = tree_leaves(got), jax.tree.leaves(want)
    assert len(lg) == len(lw)
    for a, b in zip(lg, lw):
        np.testing.assert_array_equal(_n(a), np.asarray(b))


def _close(got, want, scale):
    """Port against reference: 8 fp32 ulps of ``scale + 1`` (``scale``
    the largest term an element sums)."""
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        gap = np.abs(_n(a) - np.asarray(b))
        assert np.all(gap <= 8 * EPS32 * (scale + 1.0)), float(gap.max())


def test_live_mask_shuts_dead_pod_out_of_merge():
    """A dead pod with a nonfinite replica and an open gate contributes
    nothing: the masked merge equals the survivors-only merge (bitwise in
    the port) and stays finite, and equals the reference's."""
    pods = _np_pods(0, 3)
    pods["w"][1] = np.nan  # diverged/dead replica
    wg = _np_pods(1, 1)["w"][0]
    gates = np.array([True, True, True])   # its gate even claims to push
    losses = np.array([0.8, np.nan, 1.2], np.float32)
    live = np.array([True, False, True])
    _, g_masked, _, any_push = ths.hermes_merge(
        _t(pods), torch.from_numpy(gates), torch.from_numpy(losses),
        {"w": torch.from_numpy(wg)}, torch.tensor(1.0),
        live=torch.from_numpy(live))
    assert bool(any_push)
    assert bool(torch.isfinite(g_masked["w"]).all())
    small = {"w": pods["w"][[0, 2]]}
    _, g_small, _, _ = ths.hermes_merge(
        _t(small), torch.tensor([True, True]), torch.tensor([0.8, 1.2]),
        {"w": torch.from_numpy(wg)}, torch.tensor(1.0))
    assert torch.equal(g_masked["w"], g_small["w"])
    _, j_masked, _, _ = jhs.hermes_merge(
        _j(pods), jnp.asarray(gates), jnp.asarray(losses), {"w": wg},
        jnp.float32(1.0), live=jnp.asarray(live))
    scale = np.abs(wg) + np.abs(small["w"]).max(axis=0)
    _close(g_masked, j_masked, scale)


def test_all_dead_round_is_identity():
    pods = _np_pods(2, 2)
    wg = _np_pods(3, 1)["w"][0]
    _, g, _, any_push = ths.hermes_merge(
        _t(pods), torch.tensor([True, True]), torch.tensor([0.5, 0.5]),
        {"w": torch.from_numpy(wg)}, torch.tensor(1.0),
        live=torch.zeros(2, dtype=torch.bool))
    _, jg, _, j_any = jhs.hermes_merge(
        _j(pods), jnp.array([True, True]), jnp.array([0.5, 0.5]),
        {"w": wg}, jnp.float32(1.0), live=jnp.zeros((2,), bool))
    assert not bool(any_push) and not bool(j_any)
    np.testing.assert_array_equal(_n(g["w"]), wg)
    _bitwise(g, jg)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_masked_round_equals_reduced_round(compression):
    """One live-masked ``hermes_round`` at n_pods, restricted to the
    survivors, is bitwise the same round at n_pods-1 in the port (the
    invariant the elastic shrink relies on); gates and gate state equal
    the reference's bitwise, merged values within the stated ulps."""
    jcfg, tcfg = _cfgs(alpha=-0.1, window=4, lam=2, compression=compression)
    n, drop, keep = 3, 1, [0, 2]
    pods = _np_pods(4, n, (4, 512))
    wg = {"w": np.zeros((4, 512), np.float32)}
    jpods, jgst, jerr, jwg = _j(pods), jhs.hermes_pod_state(jcfg, n), None, \
        _j(wg)
    tpods, tgst, terr, twg = _t(pods), ths.hermes_pod_state(tcfg, n, CPU), \
        None, _t(wg)
    # warm the gate queues so z-scores are defined and gates can open
    for r in range(3):
        losses = np.array([1.0, 1.0, 1.0], np.float32) + np.float32(0.01 * r)
        jo = jhs.hermes_round(jpods, jgst, jnp.asarray(losses), jwg,
                              jnp.float32(1.0), jcfg, error=jerr)
        to = ths.hermes_round(tpods, tgst, torch.from_numpy(losses), twg,
                              torch.tensor(1.0), tcfg, error=terr)
        jgst, jerr, jpods, jwg = (jo["gup"], jo["error"], jo["pod_params"],
                                  jo["w_global"])
        tgst, terr, tpods, twg = (to["gup"], to["error"], to["pod_params"],
                                  to["w_global"])
    # both sides continue from the reference's state
    tpods, tgst, twg = _t(jax.device_get(jpods)), _t(jax.device_get(jgst)), \
        _t(jax.device_get(jwg))
    terr = None if jerr is None else _t(jax.device_get(jerr))
    dead = {"w": tpods["w"].clone()}
    dead["w"][drop] = float("nan")
    live = torch.tensor([True, False, True])
    losses = torch.tensor([0.2, float("nan"), 0.25])  # sharp drop: open
    big = ths.hermes_round(dead, tgst, losses, twg, torch.tensor(1.0), tcfg,
                           live=live, error=terr)
    assert bool(big["any_push"])
    small = ths.hermes_round(
        tel.shrink_pod_tree(tpods, keep), tel.shrink_pod_tree(tgst, keep),
        losses[keep], twg, torch.tensor(1.0), tcfg,
        error=tel.shrink_pod_tree(terr, keep))
    assert torch.equal(big["w_global"]["w"], small["w_global"]["w"])
    assert torch.equal(tel.shrink_pod_tree(big["pod_params"], keep)["w"],
                       small["pod_params"]["w"])
    for k in big["gup"]:
        assert torch.equal(tel.shrink_pod_tree(big["gup"], keep)[k],
                           small["gup"][k]), k
    if big["error"] is not None:
        assert torch.equal(tel.shrink_pod_tree(big["error"], keep)["w"],
                           small["error"]["w"])
    # the reference's masked round on the same inputs
    jdead = jax.tree.map(lambda x: x.at[drop].set(jnp.nan), jpods)
    jbig = jhs.hermes_round(jdead, jgst, jnp.asarray(losses.numpy()), jwg,
                            jnp.float32(1.0), jcfg, live=jnp.asarray(
                                live.numpy()), error=jerr)
    np.testing.assert_array_equal(_n(big["gates"]), np.asarray(jbig["gates"]))
    for k in big["gup"]:
        np.testing.assert_array_equal(_n(big["gup"][k]),
                                      np.asarray(jbig["gup"][k]), err_msg=k)
    scale = np.abs(pods["w"]).max() + np.abs(_n(twg["w"])).max()
    _close(big["w_global"], jbig["w_global"], scale)
    _close(tel.shrink_pod_tree(big["pod_params"], keep),
           jel.shrink_pod_tree(jbig["pod_params"], keep), scale)


def test_drop_pod_equivalence_harness():
    """The full multi-round harness holds bitwise in the port, and its
    report equals the reference's key for key (the mesh fields become
    group sizes: None unplaced)."""
    kw = dict(n_pods=3, drop=2, rounds_before=3, rounds_after=2)
    out = tel.drop_pod_equivalence(device="cpu", **kw)
    want = jel.drop_pod_equivalence(**kw)
    assert out["bit_identical"] and want["bit_identical"]
    assert out["survivors"] == want["survivors"] == [0, 1]
    for k in ("n_pods", "dropped", "rounds", "compression"):
        assert out[k] == want[k], k
    assert out["group"] is None and out["survivor_group"] is None


@pytest.mark.parametrize("compression", ["none", "fp16", "int8"])
def test_drop_pod_equivalence_every_pinned_format(compression):
    """The formats the reference pins resize-invariant: pod 1 of 4 dies
    (rows renumber), each round with the gates on the demo schedule."""
    jcfg, tcfg = _cfgs(alpha=-0.5, beta=0.1, lam=2, window=4,
                       compression=compression, min_live_pods=1)
    out = tel.drop_pod_equivalence(n_pods=4, drop=1, cfg=tcfg, device="cpu")
    want = jel.drop_pod_equivalence(n_pods=4, drop=1, cfg=jcfg)
    assert out["bit_identical"] and out["survivors"] == want["survivors"]
    assert out["rounds"] == want["rounds"]


def test_shrink_pod_tree_migrates_by_index():
    tcfg, jcfg = HermesConfig(window=3), JHermesConfig(window=3)
    gst = ths.hermes_pod_state(tcfg, 4, CPU)
    gst = {k: v.clone() for k, v in gst.items()}
    for v in gst.values():
        v[2] += 7
    jgst = {k: jnp.asarray(_n(v)) for k, v in gst.items()}
    small = tel.shrink_pod_tree(gst, [0, 2])
    for k in gst:
        assert small[k].shape[0] == 2
        assert torch.equal(small[k][1], gst[k][2]), k
    _bitwise(small, jel.shrink_pod_tree(jgst, [0, 2]))
    _bitwise(tel.shrink_pod_tree(gst, [3, 1, 0]),
             jel.shrink_pod_tree(jgst, [3, 1, 0]))
    assert tel.shrink_pod_tree(None, [0]) is None
    assert jcfg.window == tcfg.window


def test_elastic_shrink_respects_min_live_pods():
    jcfg, tcfg = _cfgs(min_live_pods=2)
    pods = _np_pods(5, 3)
    out, groups = tel.elastic_shrink({"pod_params": _t(pods)}, [0, 1], None,
                                     cfg=tcfg)
    jout, mesh = jel.elastic_shrink({"pod_params": _j(pods)}, [0, 1], None,
                                    cfg=jcfg)
    assert groups is None and mesh is None
    assert out["pod_params"]["w"].shape[0] == 2
    _bitwise(out["pod_params"], jout["pod_params"])
    for fn, st, c in ((tel.elastic_shrink, _t(pods), tcfg),
                      (jel.elastic_shrink, _j(pods), jcfg)):
        with pytest.raises(ValueError, match="min_live_pods"):
            fn({"pod_params": st}, [0], None, cfg=c)


def test_survivor_allocations_drops_dead_and_covers_survivors():
    jcfg, tcfg = JHermesConfig(), HermesConfig()
    times = {"a": 1.0, "b": 1.1, "c": 0.9, "d": 1.0, "dead": 9.0}
    new = tel.survivor_allocations(
        times, {k: Allocation(256, 16) for k in times}, ["dead"], tcfg,
        n_train=4096)
    want = jel.survivor_allocations(
        times, {k: JAllocation(256, 16) for k in times}, ["dead"], jcfg,
        n_train=4096)
    assert set(new) == {"a", "b", "c", "d"}
    # without the purge the dead straggler is the IQR outlier; with it the
    # survivors are a tight cluster and nothing needs resizing
    assert all(a.dss >= 32 for a in new.values())
    assert {k: (a.dss, a.mbs) for k, a in new.items()} == \
        {k: (a.dss, a.mbs) for k, a in want.items()}
    # a straggler among the survivors is re-sized as the reference does
    times = {"a": 1.0, "b": 1.1, "c": 0.9, "d": 4.0, "dead": 9.0}
    new = tel.survivor_allocations(
        times, {k: Allocation(256, 16) for k in times}, ["dead"], tcfg,
        n_train=4096)
    want = jel.survivor_allocations(
        times, {k: JAllocation(256, 16) for k in times}, ["dead"], jcfg,
        n_train=4096)
    assert {k: (a.dss, a.mbs) for k, a in new.items()} == \
        {k: (a.dss, a.mbs) for k, a in want.items()}


def test_membership_knobs_validate():
    """Both packages refuse the same knobs: the reference asserts, the
    port's ``validate`` raises ``ValueError``."""
    for cfg in (HermesConfig, JHermesConfig):
        cfg(failure_timeout_factor=1.5, min_live_pods=3).validate()
    for kw in ({"failure_timeout_factor": 0.0}, {"min_live_pods": 0}):
        with pytest.raises(AssertionError):
            JHermesConfig(**kw).validate()
        with pytest.raises(ValueError):
            HermesConfig(**kw).validate()


def _dispatch_all_push(jcfg, tcfg, n):
    """Both packages dispatch from one state until every pod pushes; the
    port's inputs are the reference's (int8 draws no noise)."""
    rng = np.random.default_rng(11)
    wg = {"l0": rng.normal(size=(8, 16)).astype(np.float32),
          "l1": rng.normal(size=(16,)).astype(np.float32)}
    pods = {k: (g[None] + 0.01 * rng.normal(size=(n,) + g.shape))
            .astype(np.float32) for k, g in wg.items()}
    jgup, tgup = jhs.hermes_pod_state(jcfg, n), \
        ths.hermes_pod_state(tcfg, n, CPU)
    for r in range(3):
        losses = np.full((n,), 1.0 - 0.01 * r, np.float32)
        jgup = jhs.hermes_dispatch(_j(pods), jgup, jnp.asarray(losses),
                                   _j(wg), jnp.float32(1.0), jcfg)["gup"]
        tgup = ths.hermes_dispatch(_t(pods), tgup, torch.from_numpy(losses),
                                   _t(wg), torch.tensor(1.0), tcfg)["gup"]
    losses = np.array([0.2, 0.25, 0.3], np.float32)  # all push
    jdp = jhs.hermes_dispatch(_j(pods), jgup, jnp.asarray(losses), _j(wg),
                              jnp.float32(1.0), jcfg)
    tdp = ths.hermes_dispatch(_t(pods), tgup, torch.from_numpy(losses),
                              _t(wg), torch.tensor(1.0), tcfg)
    return pods, wg, jdp, tdp


def test_elastic_shrink_flushes_pending_under_survivor_mask():
    """``elastic_shrink`` on a state carrying an async pending buffer
    commits it first under the survivor mask: the survivors' in-flight
    pushes land, the dropped pod's never does, and the resized state
    carries no pending.  In the port bitwise the masked commit then the
    rows; against the reference's ``elastic_shrink`` on the same inputs,
    gates and gate state bitwise, merged values within the ulps."""
    kw = dict(alpha=-1.3, beta=0.1, lam=2, window=4, compression="int8",
              error_feedback=True, min_live_pods=1)
    jcfg, tcfg = _cfgs(**kw)
    n, keep = 3, [0, 2]  # pod 1 dies with its push in flight
    pods, wg, jdp, tdp = _dispatch_all_push(jcfg, tcfg, n)
    assert _n(tdp["gates"]).all() and np.asarray(jdp["gates"]).all()
    for k in tdp["gup"]:
        np.testing.assert_array_equal(_n(tdp["gup"][k]),
                                      np.asarray(jdp["gup"][k]))
    state = {"pod_params": _t(pods), "gup": tdp["gup"],
             "error": tdp["error"], "w_global": _t(wg),
             "pending": tdp["pending"]}
    new_state, groups = tel.elastic_shrink(state, keep, None, cfg=tcfg)
    assert new_state["pending"] is None and groups is None
    live = torch.tensor([True, False, True])
    cm = ths.hermes_commit(_t(pods), tdp["pending"], _t(wg), cfg=tcfg,
                           live=live)
    for a, b in zip(tree_leaves(new_state["w_global"]),
                    tree_leaves(cm["w_global"])):
        assert torch.equal(a, b)
    for k in pods:
        assert torch.equal(new_state["pod_params"][k],
                           cm["pod_params"][k][keep])
    jstate = {"pod_params": _j(pods), "gup": jdp["gup"],
              "error": jdp["error"], "w_global": _j(wg),
              "pending": jdp["pending"]}
    jnew, _ = jel.elastic_shrink(jstate, keep, None, cfg=jcfg)
    _bitwise(new_state["gup"], jnew["gup"])
    scale = max(np.abs(a).max() for a in pods.values()) + 1.0
    _close(new_state["w_global"], jnew["w_global"], scale)
    _close(new_state["pod_params"], jnew["pod_params"], scale)
    _close(new_state["error"], jnew["error"], scale)


def test_flush_pending_passes_a_state_without_pending():
    state = {"pod_params": _t(_np_pods(6, 2)), "pending": None}
    assert tel.flush_pending(state) is state


class _PodKeyed:
    """int4 noise keyed by original pod id: draw at 4 rows, keep ``ids``."""

    def __init__(self, ids):
        from repro_torch.dist.wire import GeneratorNoise
        self.base, self.ids = GeneratorNoise(3, CPU), list(ids)

    def __call__(self, round_step, leaf, shape):
        return self.base(round_step, leaf, (4,) + tuple(shape[1:]))[self.ids]


@pytest.mark.parametrize("compression", ["none", "fp16", "int8", "int4"])
def test_masked_equals_shrunk_with_every_survivor_open(compression):
    """The invariant under every elastic proof, with three gates open and
    the dead pod in the middle (the demo schedule opens one pod a round,
    whose merge weight sums alone): bitwise in the port, the merge's
    denominator summed in pod order so that the masked pod's zero adds
    nothing.  int4 with the dither keyed by original pod id."""
    cfg = HermesConfig(alpha=-0.5, window=4, lam=2, compression=compression)
    rng = np.random.default_rng(21)
    wg = {"w": torch.from_numpy(rng.normal(size=(4, 512)).astype(np.float32)),
          "b": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32))}
    pods = tree_map(lambda g: g[None] + 0.01 * torch.from_numpy(
        rng.normal(size=(4,) + tuple(g.shape)).astype(np.float32)), wg)
    gup = ths.hermes_pod_state(cfg, 4, CPU)
    for level in (3.0, 3.2):
        gup = ths.gup_gate(gup, torch.full((4,), level), cfg)[1]
    losses = torch.tensor([2.1, float("nan"), 2.0, 2.3])
    keep = [0, 2, 3]
    four = _PodKeyed(range(4)) if compression == "int4" else None
    three = _PodKeyed(keep) if compression == "int4" else None
    big = ths.hermes_round(pods, gup, losses, wg, torch.tensor(3.4), cfg,
                           live=torch.tensor([True, False, True, True]),
                           round_step=5, noise=four)
    small = ths.hermes_round(tel.shrink_pod_tree(pods, keep),
                             tel.shrink_pod_tree(gup, keep), losses[keep],
                             wg, torch.tensor(3.4), cfg, round_step=5,
                             noise=three)
    assert big["gates"].tolist() == [True, False, True, True]
    for a, b in zip(tree_leaves(big["w_global"]),
                    tree_leaves(small["w_global"])):
        assert torch.equal(a, b)
    for key in ("pod_params", "error", "gup"):
        if big[key] is None:
            assert small[key] is None
            continue
        for a, b in zip(tree_leaves(tel.shrink_pod_tree(big[key], keep)),
                        tree_leaves(small[key])):
            assert torch.equal(a, b), key


def test_ordered_sum_ignores_a_zero_anywhere():
    """The merge's denominator: a left fold, so a zero weight anywhere
    leaves every bit of the sum (a reduction may regroup)."""
    g = torch.Generator().manual_seed(0)
    for _ in range(200):
        v = torch.rand(5, generator=g) + 0.1
        for at in range(6):
            z = torch.cat([v[:at], torch.zeros(1), v[at:]])
            assert torch.equal(ths._ordered_sum(z), ths._ordered_sum(v))
    assert float(ths._ordered_sum(torch.tensor([1.0, 2.0, 3.0]))) == 6.0
