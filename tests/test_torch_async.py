"""The port's async Hermes rounds, on the CPU: ``hermes_dispatch`` +
``hermes_commit`` against the port's own ``hermes_round``, and the async
trainer against ``repro.launch.train.train_hermes``."""
import numpy as np
import pytest
import torch
import jax

from repro.config import HermesConfig as JHermesConfig
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.launch import train as jtrain
from repro.models import init_lm as jinit_lm

from repro_torch.config import HermesConfig, OptimizerConfig
from repro_torch.dist import hermes_sync as ths
from repro_torch.dist.wire import GeneratorNoise
from repro_torch.launch import train as ttrain
from repro_torch.utils.trees import tree_leaves, tree_map

from torch_parity import jax_noise

# blocked on the last axis, with a tail, on a middle axis, and a scalar
# (blocked on the pod axis once stacked: the decode fallback)
SHAPES = {"a": (8, 16), "b": (16,), "c": (3, 512), "d": (2, 300, 3), "e": ()}


def _tree(rng, n_pods):
    wg = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for k, s in SHAPES.items()}
    pods = tree_map(lambda g: g[None] + torch.from_numpy(
        0.01 * rng.normal(size=(n_pods,) + tuple(g.shape))).float(), wg)
    return pods, wg


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


@pytest.mark.parametrize("dispatch", ["off", "on"])
@pytest.mark.parametrize("mode", ["none", "fp16", "int8", "int4"])
def test_dispatch_commit_bitwise_equal_to_round(mode, dispatch):
    """Back to back, dispatch + commit is hermes_round run in two halves:
    per round, for every wire format and both merge associations, the
    same gates, global model, pods and error, bit for bit (the anchor the
    async trainer's correctness hangs on)."""
    cfg = HermesConfig(alpha=-1.3, beta=0.1, lam=3, window=4,
                       compression=mode, kernel_dispatch=dispatch,
                       error_feedback=mode in ("int8", "int4"))
    n = 4
    rng = np.random.default_rng(3)
    pods, wg = _tree(rng, n)
    gup = ths.hermes_pod_state(cfg, n, torch.device("cpu"))
    err = None
    noise = GeneratorNoise(42, torch.device("cpu"))
    opened = 0
    for r in range(4):
        losses = torch.tensor([1.0 - 0.1 * r, 1.2, 0.9, 1.1 - 0.2 * r])
        L = torch.tensor(1.0)
        sync = ths.hermes_round(pods, gup, losses, wg, L, cfg, error=err,
                                round_step=r, noise=noise)
        dp = ths.hermes_dispatch(pods, gup, losses, wg, L, cfg, error=err,
                                 round_step=r, noise=noise)
        cm = ths.hermes_commit(pods, dp["pending"], wg, cfg=cfg)
        assert torch.equal(dp["gates"], sync["gates"].to(torch.bool))
        assert torch.equal(cm["gates"], dp["gates"])
        assert bool(cm["any_push"]) == bool(sync["any_push"])
        assert (dp["pending"]["payload"] is None) == (not bool(
            sync["any_push"]))
        assert _equal(dp["gup"], sync["gup"])
        assert _equal(cm["w_global"], sync["w_global"])
        assert _equal(cm["pod_params"], sync["pod_params"])
        if sync["error"] is None:
            assert dp["error"] is None
        else:
            assert _equal(dp["error"], sync["error"])
        opened += int(bool(sync["any_push"]))
        pods = tree_map(lambda p: p + torch.from_numpy(
            0.01 * rng.normal(size=tuple(p.shape))).float(),
            sync["pod_params"])
        wg, gup, err = sync["w_global"], sync["gup"], sync["error"]
    assert 0 < opened < 4


def test_closed_dispatch_commits_as_identity():
    cfg = HermesConfig(compression="int8")
    pods, wg = _tree(np.random.default_rng(0), 2)
    gup = ths.hermes_pod_state(cfg, 2, torch.device("cpu"))
    dp = ths.hermes_dispatch(pods, gup, torch.ones(2), wg, torch.tensor(1.0),
                             cfg)  # a first round never opens
    assert dp["pending"]["payload"] is None and not bool(dp["any_push"])
    cm = ths.hermes_commit(pods, dp["pending"], wg, cfg=cfg)
    assert cm["pod_params"] is pods and cm["w_global"] is wg
    # the residual starts at zero, as after a closed synchronous round
    assert all(float(e.abs().max()) == 0.0 for e in tree_leaves(dp["error"]))


@pytest.mark.parametrize("compression", ["int8", "int4"])
def test_async_train_hermes_matches_reference_on_lmtiny(compression):
    seed = 0
    run = dict(steps=8, batch=4, seq=32, pods=3, log_every=10 ** 6, seed=seed)
    hkw = dict(alpha=-0.8, beta=0.1, lam=2, eta=1.0, compression=compression,
               async_rounds=True)
    want = jtrain.train_hermes(
        jtrain._preset("lmtiny"), opt_cfg=JOptimizerConfig(name="adamw",
                                                           lr=3e-3),
        hcfg=JHermesConfig(**hkw), **run)
    params0 = jax.device_get(
        jinit_lm(jtrain._preset("lmtiny"), jax.random.PRNGKey(seed))[0])
    got = ttrain.train_hermes(
        ttrain._preset("lmtiny"), opt_cfg=OptimizerConfig(name="adamw",
                                                          lr=3e-3),
        hcfg=HermesConfig(**hkw), device="cpu", params0=params0,
        noise=jax_noise(seed), **run)
    assert [(s, g) for s, _, g in got["history"]] == \
        [(s, g) for s, _, g in want["history"]]
    for k in ("merges", "rounds", "async_rounds", "dispatched", "committed",
              "drained"):
        assert got[k] == want[k], k
    assert got["drained"] and got["dispatched"] == got["committed"]
    assert 0 < got["merges"] < got["rounds"]
    # fp32 on two frameworks: matmuls and reductions sum in other orders
    # (the tolerance of the synchronous twin in test_torch_train.py)
    np.testing.assert_allclose([l for _, l, _ in got["history"]],
                               [l for _, l, _ in want["history"]], rtol=1e-4)
    np.testing.assert_allclose(got["global_loss"], want["global_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["pod_losses"], want["pod_losses"],
                               rtol=1e-4)
