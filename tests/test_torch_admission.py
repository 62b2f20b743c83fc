"""Admission, the grow path's gate state and the in-flight payload spec of
the port against ``repro.dist`` on the CPU: ``prob`` admission bitwise
under the reference's own uniforms, both admission modes through a whole
lmtiny ``train_hermes`` run, ``hermes_grow_pod_state`` and
``payload_buffer_spec``."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.config import HermesConfig as JHermesConfig
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.dist import hermes_sync as jhs
from repro.dist import wire as jwire
from repro.launch import train as jtrain
from repro.models import init_lm as jinit_lm

from repro_torch.config import HermesConfig, OptimizerConfig
from repro_torch.core.gup import gup_gate
from repro_torch.dist import hermes_sync as ths
from repro_torch.dist import wire as twire
from repro_torch.dist.compression import encode_tree
from repro_torch.launch import train as ttrain
from repro_torch.utils.trees import flatten_up_to, tree_flatten, tree_map

from torch_parity import jax_noise, to_numpy, to_torch


@pytest.mark.parametrize("prate", [0.1, 0.3, 0.5, 0.9])
def test_prob_admission_matches_reference_bitwise(prate):
    jcfg = JHermesConfig(participation_rate=prate, admission="prob")
    tcfg = HermesConfig(participation_rate=prate, admission="prob")
    rng = np.random.default_rng(int(prate * 10))
    admitted = 0
    for seed in (0, 3):
        for round_step in (0, 1, 4, 9, 20):
            gates = rng.random(8) < 0.7
            losses = rng.random(8).astype(np.float32) + 1.0
            key = jax.random.fold_in(jax.random.PRNGKey(seed), round_step)
            want = np.asarray(jhs.admit_gates(jnp.asarray(gates),
                                              jnp.asarray(losses), jcfg,
                                              rng=key))
            got = ths.admit_gates(to_torch(gates), to_torch(losses), tcfg,
                                  round_step=round_step,
                                  noise=jax_noise(seed))
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(to_numpy(got), want)
            admitted += int(want.sum())
    assert admitted > 0


@pytest.mark.parametrize("prate", [0.25, 0.5, 0.8])
def test_prob_admission_is_a_thinning_at_the_rate(prate):
    """The port's own generator: admitted is a subset of open, and the
    admitted share of the open gates is Bernoulli(prate) (within 4.5
    standard deviations over 12,800 open gates)."""
    cfg = HermesConfig(participation_rate=prate, admission="prob")
    noise = twire.GeneratorNoise(7, torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    n_open = n_admitted = 0
    for round_step in range(200):
        gates = torch.rand(128, generator=gen) < 0.5
        got = ths.admit_gates(gates, torch.ones(128), cfg,
                              round_step=round_step, noise=noise)
        assert not bool((got & ~gates).any())
        n_open += int(gates.sum())
        n_admitted += int(got.sum())
    share = n_admitted / n_open
    sigma = (prate * (1 - prate) / n_open) ** 0.5
    assert abs(share - prate) < 4.5 * sigma, (share, prate)
    # one round and one leaf draw the same bits every time
    a = ths.admit_gates(torch.ones(64, dtype=torch.bool), torch.ones(64),
                        cfg, round_step=3, noise=noise)
    b = ths.admit_gates(torch.ones(64, dtype=torch.bool), torch.ones(64),
                        cfg, round_step=3, noise=noise)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="noise"):
        ths.admit_gates(torch.ones(4, dtype=torch.bool), torch.ones(4), cfg)


@pytest.mark.parametrize("admission", ["topk", "prob"])
def test_train_hermes_with_admission_matches_reference(admission):
    seed = 0
    run = dict(steps=8, batch=4, seq=32, pods=4, log_every=10 ** 6,
               seed=seed)
    hkw = dict(alpha=-0.8, beta=0.1, lam=2, eta=1.0, compression="int4",
               participation_rate=0.5, admission=admission)
    want = jtrain.train_hermes(
        jtrain._preset("lmtiny"),
        opt_cfg=JOptimizerConfig(name="adamw", lr=3e-3),
        hcfg=JHermesConfig(**hkw), **run)
    params0 = jax.device_get(
        jinit_lm(jtrain._preset("lmtiny"), jax.random.PRNGKey(seed))[0])
    got = ttrain.train_hermes(
        ttrain._preset("lmtiny"),
        opt_cfg=OptimizerConfig(name="adamw", lr=3e-3),
        hcfg=HermesConfig(**hkw), device="cpu", params0=params0,
        noise=jax_noise(seed), **run)
    assert [(s, g) for s, _, g in got["history"]] == \
        [(s, g) for s, _, g in want["history"]]
    assert (got["merges"], got["rounds"]) == (want["merges"], want["rounds"])
    assert 0 < got["merges"] < got["rounds"]
    if admission == "topk":
        # a round ships at most max(1, floor(0.5 * n_open)) <= 2 of 4 pods
        assert max(g for _, _, g in got["history"]) <= 2
    np.testing.assert_allclose([l for _, l, _ in got["history"]],
                               [l for _, l, _ in want["history"]], rtol=1e-4)
    np.testing.assert_allclose(got["global_loss"], want["global_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["pod_losses"], want["pod_losses"],
                               rtol=1e-4)


@pytest.mark.parametrize("n_new", [1, 3])
def test_grow_pod_state_matches_reference(n_new):
    cfg = HermesConfig(alpha=-1.1, beta=0.2, lam=2)
    jcfg = JHermesConfig(alpha=-1.1, beta=0.2, lam=2)
    state = ths.hermes_pod_state(cfg, 3, torch.device("cpu"))
    rng = np.random.default_rng(0)
    for _ in range(7):  # a history: queues, counts and alphas move
        _, state = gup_gate(state, torch.from_numpy(
            rng.random(3).astype(np.float32) + 1.0), cfg)
    jstate = {k: jnp.asarray(to_numpy(v)) for k, v in state.items()}
    want = jhs.hermes_grow_pod_state(jstate, jcfg, n_new)
    got = ths.hermes_grow_pod_state(state, cfg, n_new)
    assert sorted(got) == sorted(want)
    for k in want:
        assert to_numpy(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(to_numpy(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    assert got["queue"].shape[0] == 3 + n_new
    assert float(state["alpha"][0]) != cfg.alpha  # the old rows moved


def _spec_items(spec, treedef):
    return [{k: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
             for k, a in d.items()} for d in flatten_up_to(treedef, spec)]


@pytest.mark.parametrize("mode", ["none", "fp16", "int8", "int4"])
def test_payload_buffer_spec_matches_reference_and_the_wire(mode):
    params = jax.device_get(
        jinit_lm(jtrain._preset("lmtiny"), jax.random.PRNGKey(0))[0])
    # a scalar leaf and one with a short tail beside the LM's own leaves
    params["extra"] = {"s": np.float32(1.5),
                       "t": np.ones((3, 300), np.float32)}
    tparams = tree_map(lambda a: torch.as_tensor(np.array(a)), params)
    _, treedef = tree_flatten(tparams)
    n_pods = 3
    want = jwire.payload_buffer_spec(params, mode, n_pods)
    got = twire.payload_buffer_spec(tparams, mode, n_pods)
    want_items = [{k: (tuple(a.shape), str(a.dtype)) for k, a in d.items()}
                  for d in jax.tree.leaves(
                      want, is_leaf=lambda x: isinstance(x, dict)
                      and all(hasattr(v, "shape") for v in x.values()))]
    assert _spec_items(got, treedef) == want_items
    assert all(a.device.type == "meta" for d in flatten_up_to(treedef, got)
               for a in d.values())
    # and what the port's encode actually ships for the stacked delta
    gen = torch.Generator().manual_seed(0)
    delta = tree_map(lambda x: 1e-2 * torch.randn(
        (n_pods,) + twire.norm_shape(x.shape), generator=gen), tparams)
    payloads, _, _ = encode_tree(delta, mode, with_residual=False)
    assert _spec_items(payloads, treedef) == _spec_items(got, treedef)
