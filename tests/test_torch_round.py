"""The port's gate and Hermes round against the JAX reference, on the CPU.

Every round hands both sides the same inputs (numpy, from a seed), so a
comparison never inherits an earlier round's rounding.  The int4 noise is
the reference's own threefry draw, injected into the port.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.config import HermesConfig as JHermesConfig
from repro.core.gup import gup_gate_jax, gup_state_jax
from repro.dist import hermes_sync as jhs

from repro_torch.config import HermesConfig as THermesConfig
from repro_torch.core.gup import gup_gate
from repro_torch.dist import hermes_sync as ths

from torch_parity import jax_noise
from torch_parity import to_numpy as _n
from torch_parity import to_torch as _t

EPS32 = np.finfo(np.float32).eps


def _tree_t(tree):
    return jax.tree.map(_t, tree)


def _configs(**kw):
    return JHermesConfig(**kw), THermesConfig(**kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gup_gate_matches_reference_over_loss_streams(seed):
    jcfg, tcfg = _configs(alpha=-1.0, beta=0.2, lam=3, window=5)
    rng = np.random.default_rng(seed)
    n_pods, steps = 3, 30
    # decreasing noisy losses, with plateaus so alpha decays too
    trend = np.linspace(3.0, 1.0, steps)[:, None]
    stream = (trend + rng.normal(0, 0.15, (steps, n_pods))).astype(np.float32)
    stream[10:16] = stream[10]
    js = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (n_pods,) + x.shape),
                      gup_state_jax(jcfg))
    ts = ths.hermes_pod_state(tcfg, n_pods, torch.device("cpu"))
    gate = jax.jit(jax.vmap(lambda s, x: gup_gate_jax(s, x, jcfg)))
    pushes = 0
    for x in stream:
        jp, js = gate(js, jnp.asarray(x))
        tp, ts = gup_gate(ts, _t(x), tcfg)
        np.testing.assert_array_equal(_n(tp), np.asarray(jp))
        for k in ("queue", "count", "alpha", "n_iter"):
            np.testing.assert_array_equal(_n(ts[k]), np.asarray(js[k]), k)
        pushes += int(np.sum(np.asarray(jp)))
    assert 0 < pushes < n_pods * steps


def test_admit_gates_topk_matches_reference():
    jcfg, tcfg = _configs(participation_rate=0.5)
    rng = np.random.default_rng(0)
    for _ in range(20):
        gates = rng.random(6) < 0.6
        losses = rng.choice([1.0, 2.0, 3.0], 6).astype(np.float32)  # ties
        want = np.asarray(jhs.admit_gates(jnp.asarray(gates),
                                          jnp.asarray(losses), jcfg))
        got = ths.admit_gates(_t(gates), _t(losses), tcfg)
        np.testing.assert_array_equal(_n(got), want)


def _pods_tree(rng, n_pods):
    """Leaves blocked on a middle axis, on the last axis, and with a tail."""
    shapes = {"a": (3, 512), "b": {"c": (2, 70), "d": (768, 2, 3)}}
    glob = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                        shapes, is_leaf=lambda s: isinstance(s, tuple))
    pods = jax.tree.map(
        lambda g: (g[None] + 0.05 * rng.normal(size=(n_pods,) + g.shape)
                   ).astype(np.float32), glob)
    return glob, pods


def _assert_merged_close(got, want, glob, pods):
    """Both sides compute the same association in fp32, but XLA may contract
    a multiply-add into an FMA inside its compiled loop body: allow a few
    ulps of the largest term an element sums."""
    for gt, wt, g, p in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                            jax.tree.leaves(glob), jax.tree.leaves(pods)):
        scale = np.abs(g) + np.max(np.abs(p), axis=0)  # broadcasts to pods
        gap = np.abs(_n(gt) - np.asarray(wt))
        assert np.all(gap <= 8 * EPS32 * (scale + 1.0)), float(gap.max())


@pytest.mark.parametrize("compression,dispatch", [
    ("none", "off"), ("none", "on"), ("int4", "off"), ("int4", "on"),
    ("int8", "off"), ("int8", "on"),
])
def test_hermes_round_matches_reference(compression, dispatch):
    n_pods, seed = 3, 5
    jcfg, tcfg = _configs(alpha=-0.5, lam=2, window=4,
                          compression=compression, kernel_dispatch=dispatch)
    rng = np.random.default_rng(11)
    glob, pods = _pods_tree(rng, n_pods)
    err = None
    js = jhs.hermes_pod_state(jcfg, n_pods)
    ts = ths.hermes_pod_state(tcfg, n_pods, torch.device("cpu"))
    use_kernel = dispatch == "on"
    # round 0 is closed (fewer than two losses queued); later rounds open
    # some gates, and the last loss row opens none of them
    loss_rows = np.array([[3.0, 3.1, 2.9], [2.8, 3.0, 2.9], [2.0, 3.2, 1.9],
                          [1.5, 3.3, 2.5], [4.0, 4.0, 4.0]], np.float32)
    opened = 0
    for r, losses in enumerate(loss_rows):
        L = np.float32(2.5 + r)
        jout = jhs.hermes_round(
            jax.tree.map(jnp.asarray, pods), js, jnp.asarray(losses),
            jax.tree.map(jnp.asarray, glob), jnp.asarray(L), jcfg,
            error=None if err is None else jax.tree.map(jnp.asarray, err),
            use_kernel=use_kernel,
            rng=jax.random.fold_in(jax.random.PRNGKey(seed), r))
        tout = ths.hermes_round(
            _tree_t(pods), ts, _t(losses), _tree_t(glob), torch.tensor(L),
            tcfg, error=None if err is None else _tree_t(err),
            use_kernel=use_kernel, round_step=r, noise=jax_noise(seed))
        np.testing.assert_array_equal(_n(tout["gates"]),
                                      np.asarray(jout["gates"]))
        assert bool(tout["any_push"]) == bool(jout["any_push"])
        for k in ("queue", "count", "alpha", "n_iter"):
            np.testing.assert_array_equal(_n(tout["gup"][k]),
                                          np.asarray(jout["gup"][k]))
        _assert_merged_close(tout["w_global"], jout["w_global"], glob, pods)
        _assert_merged_close(tout["pod_params"], jout["pod_params"], glob,
                             pods)
        if compression in ("int8", "int4"):
            # The reference runs the open round under lax.cond, where XLA
            # may fuse ``eff - q*s`` into one FMA: the residuals agree to a
            # few ulps.  One quantum flipped on either side would show as
            # a gap of ~scale/7 (int4) or ~scale/127 (int8), far above this
            # bound.
            _assert_merged_close(tout["error"], jout["error"], glob, pods)
        else:
            assert tout["error"] is None and jout["error"] is None
        opened += int(bool(jout["any_push"]))
        # next round: identical inputs on both sides, taken from the reference
        js = jout["gup"]
        ts = jax.tree.map(_t, jax.device_get(js))
        pods = jax.tree.map(
            lambda p: (np.asarray(p) + 0.01 * rng.normal(size=p.shape)
                       ).astype(np.float32), jax.device_get(jout["pod_params"]))
        glob = jax.tree.map(np.asarray, jax.device_get(jout["w_global"]))
        err = (None if jout["error"] is None
               else jax.tree.map(np.asarray, jax.device_get(jout["error"])))
    assert 0 < opened < len(loss_rows)


def test_hermes_round_rejects_unported_modes():
    """Two-tier clusters are not ported: they raise instead of running
    another round than the reference's.  Bernoulli admission is ported
    and, as in the reference without an rng, raises without a noise
    source (``tests/test_torch_admission.py`` holds it with one)."""
    pods, glob = {"a": torch.zeros(2, 4)}, {"a": torch.zeros(4)}
    for kw, exc, match in (
            ({"n_clusters": 2}, NotImplementedError, "clusters"),
            ({"participation_rate": 0.5, "admission": "prob"}, ValueError,
             "admission")):
        cfg = THermesConfig(**kw)
        cfg.validate()
        st = ths.hermes_pod_state(cfg, 2, torch.device("cpu"))
        for half in (ths.hermes_round, ths.hermes_dispatch):
            with pytest.raises(exc, match=match):
                half(pods, st, torch.ones(2), glob, torch.tensor(1.0), cfg)
