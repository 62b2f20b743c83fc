"""The port's two-tier resize cycle and the elastic demos against
``repro.launch.elastic`` on the CPU: ``tests/test_cluster.py``'s resize
cycle, each harness bitwise within the port, the three demos' reports
key for key (the mesh fields become group sizes), and the checkpoint
restart (``run_demo``) on 8 spawned gloo ranks, a (2, 4) DeviceMesh then
(1, 4): the reference's keys, the unsharded trajectory, and the first
loss against the reference's.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch
import jax

from repro.config import HermesConfig as JHermesConfig
from repro.launch import elastic as jel

from repro_torch.config import HermesConfig
from repro_torch.launch import elastic as tel

import torch_parity  # noqa: F401  (one torch thread)


def test_cluster_resize_cycles_bit_identical():
    """shrink -> grow -> shrink over 3 cycles leaves no scar: every row
    bitwise the never-resized oracle per cycle (``tests/test_cluster.py``'s
    pin at its int8 default, the demo's configuration)."""
    out = tel.run_hermes_cluster_resize_demo(device="cpu")
    assert out == jel.run_hermes_cluster_resize_demo()
    assert out["bit_identical"] is True and out["cycles"] == 3
    assert out["shrunk_cluster_sizes"] == [2, 1]


def test_cluster_resize_cycles_lossless_wire():
    kw = dict(alpha=-0.5, beta=0.1, lam=2, window=4, compression="none",
              min_live_pods=1, rejoin_cost_rounds=0.0, n_clusters=2)
    out = tel.cluster_resize_cycle_equivalence(
        cycles=3, cfg=HermesConfig(**kw), device="cpu")
    assert out == jel.cluster_resize_cycle_equivalence(
        cycles=3, cfg=JHermesConfig(**kw))


def test_demos_report_as_the_reference():
    """The shrink and rejoin demos at 2 pods (the reference caps its pod
    count at its device count; the port takes it as given): every key of
    the reference but the mesh fields, which become group sizes (None
    unplaced)."""
    mesh = {"mesh", "survivor_mesh", "shrunk_mesh", "regrown_mesh"}
    for name in ("shrink", "rejoin"):
        got = getattr(tel, f"run_hermes_{name}_demo")(n_pods=2, device="cpu")
        want = getattr(jel, f"run_hermes_{name}_demo")(n_pods=2)
        for k in set(want) - mesh:
            assert got[k] == want[k], (name, k)
        for k in set(got) - set(want):
            assert got[k] is None, (name, k)


@pytest.fixture(scope="module")
def demos():
    """``launch.elastic.main`` once on the CPU: the three demos and the
    checkpoint restart on 8 spawned gloo ranks."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tel.main(["--device", "cpu"])
    return json.loads(out.getvalue())


def _demo_batches(vocab, n, seed=0):
    """``run_demo``'s batch stream: one generator, tokens == targets."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (16, 32)) for _ in range(n)]


def test_main_reports_the_checkpoint_restart(demos):
    """``main`` prints every demo; the checkpoint restart has the
    reference's keys: 5 steps on the (2, 4) mesh of 8 ranks, restored at
    step 5 onto (1, 4), 5 more, the loss continuous, and the allocator's
    re-balance the reference's."""
    from repro.core.allocator import dual_binary_search as jdbs
    assert {"hermes_shrink", "hermes_rejoin", "hermes_cluster_resize",
            "checkpoint_restart"} <= set(demos)
    assert demos["hermes_rejoin"]["bit_identical"]
    got = demos["checkpoint_restart"]
    assert set(got) == {"phase1_losses", "phase1_mesh", "phase2_losses",
                        "phase2_mesh", "resumed_from_step", "realloc",
                        "loss_continuous"}
    assert (got["phase1_mesh"], got["phase2_mesh"]) == ([2, 4], [1, 4])
    assert got["resumed_from_step"] == 5
    assert len(got["phase1_losses"]) == len(got["phase2_losses"]) == 5
    assert got["loss_continuous"] is True
    a = jdbs(k=0.02, t_target=1.0, dss_domain=(32, 4096))
    assert got["realloc"] == {"dss": a.dss, "mbs": a.mbs}


def test_restart_is_the_unsharded_run(demos):
    """Both phases are ``launch/steps.py``'s train step on one process
    from the same init and batches (bf16 compute, fp32 master weights,
    AdamW lr 1e-3): the mesh splits each batch over its data rows and
    averages their fp32 losses and gradients, where one process takes the
    mean over all 16 rows in bf16; measured 7e-5 apart at most over the
    10 steps, held at rtol 5e-4.  The restore onto the smaller mesh loses
    nothing: phase 2 continues the same trajectory."""
    from repro_torch.config import OptimizerConfig, ParallelConfig
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    cfg = get_smoke_config("qwen3-8b")
    setup = steps.make_train_setup(
        cfg, ShapeConfig("t", 32, 16, "train"), ParallelConfig(),
        OptimizerConfig(name="adamw", lr=1e-3), device="cpu")
    state, losses = setup.init_state(0), []
    for t in _demo_batches(cfg.vocab_size, 10):
        t = torch.from_numpy(t)
        state, loss = setup.step_fn(state, {"tokens": t, "targets": t})
        losses.append(float(loss))
    got = demos["checkpoint_restart"]
    np.testing.assert_allclose(got["phase1_losses"] + got["phase2_losses"],
                               losses, rtol=5e-4)


def test_restart_first_loss_matches_reference(demos):
    """The first step's loss against the reference's ``lm_loss`` on the
    port's initial parameters (bf16, carried across through
    ``bridge.to_numpy``) and the same batch: both compute in bf16 and sum
    in other orders, rtol 2e-3 (bf16's 8 bits, over a mean of 512
    cross-entropies of ~6)."""
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import lm_loss as jlm_loss
    from repro_torch import bridge
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import _init_params
    cfg = get_smoke_config("qwen3-8b")
    params = bridge.to_numpy(_init_params(cfg, 0, torch.device("cpu")))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    t = jnp.asarray(_demo_batches(cfg.vocab_size, 1)[0], jnp.int32)
    want = float(jlm_loss(params, {"tokens": t, "targets": t},
                          jsmoke("qwen3-8b"), impl="naive"))
    np.testing.assert_allclose(demos["checkpoint_restart"]
                               ["phase1_losses"][0], want, rtol=2e-3)
