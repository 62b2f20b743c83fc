"""The port's elastic membership, grow half (``repro_torch.launch.elastic``)
against ``repro.launch.elastic`` on the CPU: the reference's
``tests/test_elastic_grow.py``, each test fed the same numpy inputs on
both sides (the resize cycle and the demos are in
``tests/test_torch_elastic_demos.py``).  Index moves and the seeded rows
are held bitwise against the reference, the equivalence proofs bitwise
within the port, and merged values against the reference within a few
fp32 ulps of the largest term an element sums (the tolerance of
``tests/test_torch_round.py``).
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
from repro_torch.core.allocator import (
    Allocation, rejoin_gain_rounds, should_readmit,
)
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
    lg, lw = tree_leaves(got), jax.tree.leaves(want)
    assert len(lg) == len(lw)
    for a, b in zip(lg, lw):
        np.testing.assert_array_equal(_n(a), np.asarray(b))


# ---------------------------------------------------------------------------
# state seeding
# ---------------------------------------------------------------------------

def test_grow_pod_tree_appends_seeded_row():
    pods, wg = _np_pods(0, 3), {"w": _np_pods(1, 1)["w"][0]}
    grown = tel.grow_pod_tree(_t(pods), _t(wg))
    assert grown["w"].shape == (4, 6, 5)
    assert torch.equal(grown["w"][:3], torch.from_numpy(pods["w"]))
    assert torch.equal(grown["w"][3], torch.from_numpy(wg["w"]))
    _bitwise(grown, jel.grow_pod_tree(_j(pods), _j(wg)))
    _bitwise(tel.grow_pod_tree(_t(pods), _t(wg), 2),
             jel.grow_pod_tree(_j(pods), _j(wg), 2))
    assert tel.grow_pod_tree(None, _t(wg)) is None


def test_hermes_grow_pod_state_is_fresh():
    jcfg, tcfg = _cfgs(alpha=-0.7, window=5)
    gst = {k: v + 3 for k, v in ths.hermes_pod_state(tcfg, 2, CPU).items()}
    grown = ths.hermes_grow_pod_state(gst, tcfg)
    for k in gst:
        assert grown[k].shape[0] == 3
        assert torch.equal(grown[k][:2], gst[k]), k
    assert torch.equal(grown["queue"][2], torch.zeros(5))
    assert int(grown["count"][2]) == 0 and int(grown["n_iter"][2]) == 0
    assert float(grown["alpha"][2]) == np.float32(tcfg.alpha)
    _bitwise(grown, jhs.hermes_grow_pod_state(
        {k: jnp.asarray(_n(v)) for k, v in gst.items()}, jcfg))


def test_newcomer_gate_provably_shut_while_warming():
    """A fresh gate row has fewer than two queued losses for its first
    two rounds, so its gate cannot open: the property the grow leans on.
    The gates equal the reference's round by round."""
    jcfg, tcfg = _cfgs(alpha=-0.01, window=4, lam=2)  # maximally permissive
    tg = ths.hermes_grow_pod_state(ths.hermes_pod_state(tcfg, 1, CPU), tcfg)
    jg = jhs.hermes_grow_pod_state(jhs.hermes_pod_state(jcfg, 1), jcfg)
    pods = _np_pods(2, 2, (3, 4))
    tp, jp = _t(pods), _j(pods)
    tw, jw = {"w": torch.zeros(3, 4)}, {"w": jnp.zeros((3, 4))}
    for r in range(2):
        losses = np.array([1.0, 0.01], np.float32)  # a huge drop
        to = ths.hermes_round(tp, tg, torch.from_numpy(losses), tw,
                              torch.tensor(1.0), tcfg)
        jo = jhs.hermes_round(jp, jg, jnp.asarray(losses), jw,
                              jnp.float32(1.0), jcfg)
        assert not bool(to["gates"][1]), f"fresh gate opened on round {r}"
        np.testing.assert_array_equal(_n(to["gates"]), np.asarray(jo["gates"]))
        tg, tp, tw = to["gup"], to["pod_params"], to["w_global"]
        jg, jp, jw = jo["gup"], jo["pod_params"], jo["w_global"]


def test_elastic_grow_seeds_newcomer_from_global():
    jcfg, tcfg = _cfgs(window=3)
    pods, err = _np_pods(3, 2), _np_pods(5, 2)
    wg = {"w": _np_pods(4, 1)["w"][0]}
    out, groups = tel.elastic_grow(
        {"pod_params": _t(pods), "gup": ths.hermes_pod_state(tcfg, 2, CPU),
         "error": _t(err), "w_global": _t(wg)}, None, cfg=tcfg)
    want, mesh = jel.elastic_grow(
        {"pod_params": _j(pods), "gup": jhs.hermes_pod_state(jcfg, 2),
         "error": _j(err), "w_global": _j(wg)}, None, cfg=jcfg)
    assert groups is None and mesh is None
    assert out["pod_params"]["w"].shape == (3, 6, 5)
    assert torch.equal(out["pod_params"]["w"][2], torch.from_numpy(wg["w"]))
    assert torch.equal(out["error"]["w"][2], torch.zeros(6, 5))
    assert torch.equal(out["error"]["w"][:2], torch.from_numpy(err["w"]))
    assert out["gup"]["queue"].shape == (3, 3)
    assert int(out["gup"]["count"][2]) == 0
    for k in ("pod_params", "gup", "error", "w_global"):
        _bitwise(out[k], want[k])


# ---------------------------------------------------------------------------
# re-admission policy
# ---------------------------------------------------------------------------

def test_should_readmit_amortization():
    jcfg, tcfg = _cfgs(rejoin_cost_rounds=2.0)
    from repro.core.allocator import rejoin_gain_rounds as j_gain
    from repro.core.allocator import should_readmit as j_admit
    # 3 live members, 100 rounds left: gain 25 rounds >> 2 -> admit
    assert should_readmit(100.0, 3, tcfg) and j_admit(100.0, 3, jcfg)
    # 3 live members, 4 rounds left: gain 1 round < 2 -> deny
    assert not should_readmit(4.0, 3, tcfg) and not j_admit(4.0, 3, jcfg)
    assert rejoin_gain_rounds(3, 100.0) == pytest.approx(25.0) == \
        j_gain(3, 100.0)
    # a zero-cost policy admits any strictly positive gain
    assert should_readmit(0.1, 7, HermesConfig(rejoin_cost_rounds=0.0))


def test_elastic_grow_policy_gates_the_resize():
    jcfg, tcfg = _cfgs(rejoin_cost_rounds=5.0)
    pods = _np_pods(6, 2)
    t_state = {"pod_params": _t(pods),
               "gup": ths.hermes_pod_state(tcfg, 2, CPU), "error": None,
               "w_global": {"w": torch.zeros(6, 5)}}
    j_state = {"pod_params": _j(pods), "gup": jhs.hermes_pod_state(jcfg, 2),
               "error": None, "w_global": {"w": jnp.zeros((6, 5))}}
    for fn, st, cfg in ((tel.elastic_grow, t_state, tcfg),
                        (jel.elastic_grow, j_state, jcfg)):
        with pytest.raises(ValueError, match="re-admission denied"):
            fn(st, None, cfg=cfg, remaining_rounds=3.0)
        out, _ = fn(st, None, cfg=cfg, remaining_rounds=100.0)
        assert out["pod_params"]["w"].shape[0] == 3
        # remaining_rounds=None bypasses the policy (caller decided)
        out, _ = fn(st, None, cfg=cfg)
        assert out["pod_params"]["w"].shape[0] == 3


def test_rejoin_allocations_seeds_newcomer_at_median():
    jcfg, tcfg = _cfgs()
    for times in ({"a": 1.0, "b": 1.1, "c": 0.9},
                  {"a": 1.0, "b": 1.1, "c": 0.9, "d": 3.5}):
        new = tel.rejoin_allocations(
            times, {k: Allocation(256, 16) for k in times}, "back", tcfg,
            n_train=4096)
        want = jel.rejoin_allocations(
            times, {k: JAllocation(256, 16) for k in times}, "back", jcfg,
            n_train=4096)
        assert set(new) == set(times) | {"back"}
        assert {k: (a.dss, a.mbs) for k, a in new.items()} == \
            {k: (a.dss, a.mbs) for k, a in want.items()}
    # median-of-cluster seed: the newcomer is not an outlier, so it keeps
    # the median-sized allocation
    assert new["back"] == Allocation(256, 16)


# ---------------------------------------------------------------------------
# the round-trip invariant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_pods", [2, 3])
def test_shrink_grow_round_trip_bit_identical(n_pods):
    """Drop the last pod, run shrunk, re-admit, run regrown: every tensor
    bitwise the never-resized oracle in the port, and (unplaced) the
    incumbents' warm-up rounds bitwise the no-grow continuation; the
    report equals the reference's key for key."""
    kw = dict(n_pods=n_pods, rounds_before=3, rounds_shrunk=2,
              rounds_after=3)
    out = tel.rejoin_pod_equivalence(device="cpu", **kw)
    want = jel.rejoin_pod_equivalence(**kw)
    assert out["bit_identical"] and out["warmup_checked"]
    assert out["rejoined"] == n_pods - 1
    for k in ("n_pods", "rejoined", "incumbents", "rounds", "compression",
              "readmission", "bit_identical"):
        assert out[k] == want[k], k
    assert out["readmission"]["admitted"]


@pytest.mark.parametrize("compression", ["none", "fp16", "int8"])
def test_rejoin_pod_equivalence_every_pinned_format(compression):
    jcfg, tcfg = _cfgs(alpha=-0.5, beta=0.1, lam=2, window=4,
                       compression=compression, rejoin_cost_rounds=0.5)
    out = tel.rejoin_pod_equivalence(n_pods=4, cfg=tcfg, device="cpu")
    want = jel.rejoin_pod_equivalence(n_pods=4, cfg=jcfg)
    assert out["bit_identical"] and out["warmup_checked"]
    assert out["readmission"] == want["readmission"]


def test_rejoined_pod_first_open_gate_merges():
    """Once the rejoined pod's queue has warmed and its loss drops, its
    gate opens and the merge folds it in, bitwise the ``hermes_merge`` of
    that one pusher in the port, within the ulps of the reference's, and
    the newcomer refreshes from the merged model."""
    jcfg, tcfg = _cfgs(alpha=-0.5, window=4, lam=2, compression="none")
    pods = _np_pods(7, 2, (4, 8))
    out, _ = tel.elastic_grow(
        {"pod_params": _t(pods), "gup": ths.hermes_pod_state(tcfg, 2, CPU),
         "error": None, "w_global": {"w": torch.zeros(4, 8)}}, None, cfg=tcfg)
    jout, _ = jel.elastic_grow(
        {"pod_params": _j(pods), "gup": jhs.hermes_pod_state(jcfg, 2),
         "error": None, "w_global": {"w": jnp.zeros((4, 8))}}, None, cfg=jcfg)
    tp, tg, te, tw = (out["pod_params"], out["gup"], out["error"],
                      out["w_global"])
    jp, jg, je, jw = (jout["pod_params"], jout["gup"], jout["error"],
                      jout["w_global"])
    # warm every queue with flat losses (no gate opens), then a sharp drop
    # on the newcomer only, with an explicit all-live membership mask
    for r in range(3):
        losses = np.array([1.0, 1.0, 1.0], np.float32) + np.float32(0.01 * r)
        o = ths.hermes_round(tp, tg, torch.from_numpy(losses), tw,
                             torch.tensor(1.0), tcfg,
                             live=torch.ones(3, dtype=torch.bool), error=te)
        jo = jhs.hermes_round(jp, jg, jnp.asarray(losses), jw,
                              jnp.float32(1.0), jcfg,
                              live=jnp.ones((3,), bool), error=je)
        assert not bool(o["any_push"]) and not bool(jo["any_push"])
        tp, tg, te, tw = (o["pod_params"], o["gup"], o["error"],
                          o["w_global"])
        jp, jg, je, jw = (jo["pod_params"], jo["gup"], jo["error"],
                          jo["w_global"])
    step = np.random.default_rng(13).normal(size=(4, 8)).astype(np.float32)
    tp = {"w": tp["w"].clone()}
    tp["w"][2] += torch.from_numpy(step)
    jp = {"w": jp["w"].at[2].add(step)}
    losses = np.array([1.05, 1.05, 0.2], np.float32)
    o = ths.hermes_round(tp, tg, torch.from_numpy(losses), tw,
                         torch.tensor(1.0), tcfg,
                         live=torch.ones(3, dtype=torch.bool), error=te)
    jo = jhs.hermes_round(jp, jg, jnp.asarray(losses), jw, jnp.float32(1.0),
                          jcfg, live=jnp.ones((3,), bool), error=je)
    gates = _n(o["gates"])
    assert bool(o["any_push"]) and gates[2] and not gates[:2].any()
    np.testing.assert_array_equal(gates, np.asarray(jo["gates"]))
    _, oracle, _, _ = ths.hermes_merge(tp, torch.from_numpy(gates),
                                       torch.from_numpy(losses), tw,
                                       torch.tensor(1.0))
    assert torch.equal(o["w_global"]["w"], oracle["w"])
    assert torch.equal(o["pod_params"]["w"][2], o["w_global"]["w"])
    assert not torch.equal(o["w_global"]["w"], tw["w"])
    scale = np.abs(_n(tp["w"])).max() + 1.0
    gap = np.abs(_n(o["w_global"]["w"]) - np.asarray(jo["w_global"]["w"]))
    assert np.all(gap <= 8 * EPS32 * scale), float(gap.max())


def test_grow_then_shrink_is_identity_for_incumbents():
    """shrink(grow(state)) restores the incumbents' state exactly, on both
    sides."""
    jcfg, tcfg = _cfgs(window=4)
    pods, err = _np_pods(8, 3), _np_pods(9, 3)
    wg = {"w": _np_pods(10, 1)["w"][0]}
    state = {"pod_params": _t(pods), "gup": ths.hermes_pod_state(tcfg, 3, CPU),
             "error": _t(err), "w_global": _t(wg)}
    grown, _ = tel.elastic_grow(state, None, cfg=tcfg)
    back, _ = tel.elastic_shrink(grown, [0, 1, 2], None, cfg=tcfg)
    for k in ("pod_params", "error", "gup"):
        for a, b in zip(tree_leaves(back[k]), tree_leaves(state[k])):
            assert torch.equal(a, b), k
    jstate = {"pod_params": _j(pods), "gup": jhs.hermes_pod_state(jcfg, 3),
              "error": _j(err), "w_global": _j(wg)}
    jback, _ = jel.elastic_shrink(jel.elastic_grow(jstate, None, cfg=jcfg)[0],
                                  [0, 1, 2], None, cfg=jcfg)
    for k in ("pod_params", "error", "gup", "w_global"):
        _bitwise(back[k], jback[k])


# ---------------------------------------------------------------------------
# shrink-side index validation
# ---------------------------------------------------------------------------

def test_shrink_pod_tree_rejects_out_of_range_index():
    """An out-of-range index raises on both sides (``jnp.take``'s clamp
    mode once duplicated a survivor row; torch has none to fall into)."""
    pods = _np_pods(11, 3)
    for fn, tree in ((tel.shrink_pod_tree, _t(pods)),
                     (jel.shrink_pod_tree, _j(pods))):
        for bad in ([0, 3], [-1, 1]):
            with pytest.raises(ValueError, match="out of range"):
                fn(tree, bad)


def test_shrink_pod_tree_rejects_duplicates():
    pods = _np_pods(12, 3)
    for fn, tree in ((tel.shrink_pod_tree, _t(pods)),
                     (jel.shrink_pod_tree, _j(pods))):
        with pytest.raises(ValueError, match="duplicate"):
            fn(tree, [0, 0])
    # valid takes still work, in keep order
    small = tel.shrink_pod_tree(_t(pods), [2, 0])
    assert torch.equal(small["w"][0], torch.from_numpy(pods["w"][2]))
    _bitwise(small, jel.shrink_pod_tree(_j(pods), [2, 0]))
