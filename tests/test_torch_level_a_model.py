"""The port's Level-A model side against the JAX package on the CPU: the
wire's billing and ``compress_tree`` on the paper's CNN trees, the CNNs
themselves, the paper bundles, and the PS's loss-based SGD.

Inputs are made with numpy from a seed and handed to both sides.  The
bill is held exactly and ``compress_tree`` bitwise (int4 with the
reference's noise injected); the CNNs (forward, loss, gradients and two
steps of the bundle's SGD) at ``rtol=1e-5, atol=1e-6`` and ``ps_push``
at ``rtol=1e-6``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import bundles as jbundles
from repro.core import cluster as jcluster
from repro.core import loss_sgd as jsgd
from repro.dist import compression as jcomp
from repro.models import cnn as jcnn

from repro_torch import bridge
from repro_torch.core import bundles as tbundles
from repro_torch.core import loss_sgd as tsgd
from repro_torch.dist import compression as tcomp
from repro_torch.models import cnn as tcnn
from repro_torch.utils.trees import tree_leaves, tree_map

from torch_parity import jax_noise

ARCHS = {"mnist-cnn": "mnist", "cifar-alexnet": "cifar"}


def _params(arch):
    """The reference's initial parameters of ``arch``: (numpy tree, port
    tree on the CPU)."""
    p = jax.device_get(jcnn.make_paper_model(arch, jax.random.PRNGKey(3))[0])
    return p, bridge.from_numpy(p, "cpu")


def _close(got, want, rtol, atol=0.0):
    g, w = tree_leaves(bridge.to_numpy(got)), jax.tree.leaves(
        jax.device_get(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _equal(got, want):
    g, w = tree_leaves(bridge.to_numpy(got)), jax.tree.leaves(
        jax.device_get(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the wire: billing exact, compress_tree bitwise
# ---------------------------------------------------------------------------

# one push of each paper model, in bytes (the reference's bill)
BILL = {"mnist-cnn": {"none": 423464, "fp16": 211732, "int8": 113022,
                      "int4": 60089},
        "cifar-alexnet": {"none": 3993000, "fp16": 1996500, "int8": 1015890,
                          "int4": 516765}}


@pytest.mark.parametrize("mode", ["none", "fp16", "int8", "int4"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_payload_bytes_equal_reference(arch, mode):
    p, t = _params(arch)
    want = jcomp.payload_bytes(p, mode)
    assert want == BILL[arch][mode]
    assert tcomp.payload_bytes(t, mode) == want


def test_payload_bytes_refuses_the_sharding_hint():
    """The hint needs an axes tree of the parameters' structure: an empty
    one is refused; one with no rules moves no blocked axis, so the bill
    is the shape-only one, as the reference's."""
    p, t = _params("mnist-cnn")
    with pytest.raises(KeyError):
        tcomp.payload_bytes(t, "int4", param_axes={})
    axes = tree_map(lambda x: (None,) * x.ndim, t)
    assert tcomp.payload_bytes(t, "int4", param_axes=axes) == \
        jcomp.payload_bytes(p, "int4") == BILL["mnist-cnn"]["int4"]
    with pytest.raises(ValueError):
        tcomp.payload_bytes(t, "int3")


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_compress_tree_bitwise_with_residual(arch, mode):
    """Two pushes with error feedback, as the simulator makes them: the
    reconstruction and the residual of each equal the reference's."""
    rng = np.random.default_rng(8)
    p, _ = _params(arch)
    error_j = error_t = None
    for push in range(2):
        g = jax.tree.map(lambda x: (0.05 * rng.standard_normal(x.shape))
                         .astype(np.float32), p)
        key = jax.random.fold_in(jax.random.PRNGKey(7), push)
        rec_j, error_j = jcomp.compress_tree(g, mode, error=error_j, rng=key)
        rec_t, error_t = tcomp.compress_tree(
            bridge.from_numpy(g, "cpu"), mode, error=error_t,
            round_step=push, noise=jax_noise(7))
        _equal(rec_t, rec_j)
        _equal(error_t, error_j)


# ---------------------------------------------------------------------------
# the CNNs: rtol 1e-5, atol 1e-6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_paper_models_have_the_published_size(arch):
    p, _ = _params(arch)
    got = tcnn.make_paper_model(arch, torch.Generator().manual_seed(0), "cpu")
    assert tcnn.param_count(got) == jcnn.param_count(p) == \
        {"mnist-cnn": 105866, "cifar-alexnet": 998250}[arch]
    assert [tuple(x.shape) for x in tree_leaves(got)] == \
        [x.shape for x in jax.tree.leaves(p)]
    with pytest.raises(KeyError):
        tcnn.make_paper_model("lenet", torch.Generator(), "cpu")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cnn_forward_loss_grad_and_step_match_reference(arch):
    from repro_torch.core.cluster import _make_step
    p, t = _params(arch)
    jb, _ = jbundles.make_paper_bundle(ARCHS[arch], n=80)
    tb, _ = tbundles.make_paper_bundle(ARCHS[arch], n=80)
    batch = {k: v[:12] for k, v in jb.train_data.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tcnn.cnn_forward(t, tbatch["images"]).detach().numpy(),
        np.asarray(jcnn.cnn_forward(p, batch["images"])), **tol)
    np.testing.assert_allclose(float(tcnn.cnn_loss(t, tbatch)),
                               float(jcnn.cnn_loss(p, batch)), **tol)
    assert float(tcnn.cnn_accuracy(t, tbatch)) == \
        float(jcnn.cnn_accuracy(p, batch))
    leaves = [x.requires_grad_(True) for x in tree_leaves(t)]
    grads = torch.autograd.grad(tcnn.cnn_loss(t, tbatch), leaves)
    for a, b in zip(grads, jax.tree.leaves(jax.grad(jcnn.cnn_loss)(p,
                                                                   batch))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    # one step of the bundle's optimizer (cifar: momentum 0.9), twice so
    # the momentum buffer is read
    mom_j = jax.tree.map(jnp.zeros_like, p)
    _, t = _params(arch)
    mom_t = bridge.from_numpy(jax.device_get(mom_j), "cpu")
    step_j, step_t = jcluster._make_step(jb), _make_step(tb)
    for _ in range(2):
        p, mom_j = step_j(p, mom_j, batch)
        t, mom_t = step_t(t, mom_t, tbatch)
    _close(t, p, **tol)
    _close(mom_t, mom_j, **tol)
    assert tb.momentum == jb.momentum and tb.eta == jb.eta


@pytest.mark.parametrize("dataset", ["mnist", "cifar"])
def test_paper_bundle_matches_reference(dataset):
    jb, jn = jbundles.make_paper_bundle(dataset, n=150, seed=2)
    tb, tn = tbundles.make_paper_bundle(dataset, n=150, seed=2)
    assert (tn, tb.eta, tb.momentum, tb.eval_batch) == \
        (jn, jb.eta, jb.momentum, jb.eval_batch)
    for a, b in ((tb.train_data, jb.train_data), (tb.test_data,
                                                  jb.test_data)):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    params = tb.init(torch.Generator().manual_seed(0), "cpu")
    assert tb.nbytes(params) == \
        jb.nbytes(jb.init(jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# loss-based SGD at the PS: rtol 1e-6
# ---------------------------------------------------------------------------

def _sq_loss(leaves):
    """A test loss both sides compute alike from numpy leaves: fp64 mean
    of squares (the CNN's own loss is held above)."""
    return float(np.mean([np.mean(np.square(x, dtype=np.float64))
                          for x in leaves]))


def test_ps_push_matches_reference():
    p, t = _params("mnist-cnn")
    rng = np.random.default_rng(1)
    jps, tps = jsgd.ps_init(p, 0.1), tsgd.ps_init(t, 0.1)
    for push in range(3):
        G = jax.tree.map(lambda x: (0.3 * rng.standard_normal(x.shape))
                         .astype(np.float32), p)
        jps, wj, mj = jsgd.ps_push(
            jps, G, lambda w: _sq_loss(jax.tree.leaves(jax.device_get(w))))
        tps, wt, mt = tsgd.ps_push(
            tps, bridge.from_numpy(G, "cpu"),
            lambda w: _sq_loss(tree_leaves(bridge.to_numpy(w))))
        assert mt["evals"] == mj["evals"] == (1 if push == 0 else 2)
        np.testing.assert_allclose([mt["L"], mt["L_temp"]],
                                   [mj["L"], mj["L_temp"]], rtol=1e-6)
        _close(wt, wj, rtol=1e-6)
        _close(tps.sigma, jps.sigma, rtol=1e-6)
        _close(tps.global_params(), jps.global_params(), rtol=1e-6)
        assert (tps.updates, tps.initialized) == (jps.updates,
                                                  jps.initialized)
    merged = tsgd.loss_weighted_merge(t, t, 0.0, 3.0)  # the 1e-12 floor
    _close(merged, jsgd.loss_weighted_merge(p, p, 0.0, 3.0), rtol=1e-6)
