"""Donation as in-place updates, on the CPU: ``analysis/donation.py``'s
rule, and the three places the reference donates (``launch/train.py``:
the pod step, the async commit, the single trainer's step) as the port's
wrappers run them.

Each donating wrapper is held bitwise to its functional twin on the same
inputs (cloned first: a donated argument is dead after the call), its
outputs to the donated storage, and both to the reference's jitted
functions at the tolerances of the port's existing parity tests.  Sizes:
lmtiny x 3 pods, the toy round tree of ``tests/test_torch_async.py``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.analysis.donation import donated_param_numbers
from repro.config import HermesConfig as JHermesConfig
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.dist import hermes_sync as jhs
from repro.launch import train as jtrain
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss
from repro.optim import make_optimizer as jmake_optimizer

from repro_torch import bridge
from repro_torch.analysis import (
    AnalysisError, DonationAliasing, analyze, donated_leaf_ranges,
    trace_aliasing,
)
from repro_torch.config import HermesConfig, OptimizerConfig
from repro_torch.dist import hermes_sync as ths
from repro_torch.launch import analyze as tanalyze
from repro_torch.launch import train as ttrain
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.utils.trees import tree_leaves, tree_map

from torch_parity import jax_noise
from torch_parity import to_numpy as _n

CPU = torch.device("cpu")
EPS32 = np.finfo(np.float32).eps
PODS = 3
SHAPES = {"a": (8, 16), "b": (16,), "c": (3, 512), "d": (2, 300, 3)}


def _clone(tree):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _same_storage(a, b):
    return all(x.untyped_storage().data_ptr() == y.untyped_storage()
               .data_ptr() for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _held(fn, args, donated, label="t"):
    """Run ``fn(*args)`` traced and hold argnums ``donated`` to the rule;
    returns ``(result, report)``."""
    ranges = donated_leaf_ranges(args, donated)
    result, aliasing = trace_aliasing(fn, *args)
    rule = DonationAliasing({f"arg{k}": range(*v) for k, v in ranges.items()})
    return result, analyze([rule], aliasing=aliasing, label=label,
                           fail=False)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

def test_donated_leaf_ranges_mirror_reference():
    """``tests/test_analysis.py``'s flat ranges, and ``None`` as JAX's
    empty subtree."""
    jx, tx = jnp.zeros((4,), jnp.float32), torch.zeros(4)
    for build in (lambda x: ({"a": x, "b": (x, x)}, x, [x, x]),
                  lambda x: ({"n": None, "a": [x, None]}, None, (x,), x)):
        jargs, targs = build(jx), build(tx)
        for nums in ((0, 2), (1,), (0, 1, 2)):
            nums = tuple(k for k in nums if k < len(jargs))
            assert donated_leaf_ranges(targs, nums) == \
                donated_param_numbers(jargs, nums)
    assert donated_leaf_ranges(({"a": tx, "b": (tx, tx)}, tx, [tx, tx]),
                               (0, 2)) == {0: (0, 3), 2: (4, 6)}


def test_rule_passes_in_place_and_names_a_rebuild():
    a, b, step = torch.ones(4), torch.zeros(3), 0

    def in_place(x, y, s):
        x.mul_(2.0)
        return x, y + 1, s + 1

    _, rep = _held(in_place, (a, b, step), (0, 2))
    assert rep.ok, rep.violations       # the int leaf has no storage
    _, rep = _held(lambda x, y, s: (x * 2.0, y, s), (a, b, step), (0,))
    assert [v.cls for v in rep.violations] == ["dropped-donation"]
    assert rep.violations[0].detail["missing"] == [0]
    # nothing recorded: nothing proven
    with pytest.raises(AnalysisError, match="dropped-donation"):
        analyze([DonationAliasing({"x": [0]})], label="no-record")


def test_rule_honours_min_aliased():
    tree = {"p": torch.ones(2), "q": torch.ones(3), "r": torch.ones(4)}

    def partial(t):
        t["p"].add_(1.0)
        t["q"].add_(1.0)
        return {"p": t["p"], "q": t["q"], "r": t["r"] + 1.0}

    _, aliasing = trace_aliasing(partial, tree)
    full = DonationAliasing({"tree": range(3)})
    with pytest.raises(AnalysisError, match="2/3 aliased"):
        analyze([full], aliasing=aliasing)
    for need, ok in ((2, True), (3, False)):
        rule = DonationAliasing({"tree": range(3)},
                                min_aliased={"tree": need})
        assert analyze([rule], aliasing=aliasing, fail=False).ok == ok


def test_selftest_dropped_donation_raises():
    got = tanalyze.selftest_dropped_donation(CPU)
    assert got["raised"] and got["classes"] == ["dropped-donation"]


# ---------------------------------------------------------------------------
# the pod step and the single step (lmtiny, AdamW)
# ---------------------------------------------------------------------------

def _lmtiny(seed=0):
    jcfg = jtrain._preset("lmtiny")
    params0 = jax.device_get(jinit_lm(jcfg, jax.random.PRNGKey(seed))[0])
    return jcfg, ttrain._preset("lmtiny"), params0


def _batches(vocab, n, shape, seed=1):
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(0, vocab, shape) for k in ("tokens", "targets")}
            for _ in range(n)]


def _pods(params0):
    """``params0`` stacked ``PODS`` deep, as ``train_hermes`` starts."""
    return bridge.from_numpy(jax.tree.map(
        lambda a: np.broadcast_to(a[None], (PODS,) + a.shape).copy(),
        params0), CPU)


def test_pod_step_donates_bitwise_its_functional_twin():
    """Three steps: the donating pod step's pods, m, v and losses equal the
    functional twin's bit for bit, in the storage it was given; the rule
    passes it and names the twin's rebuild."""
    _, cfg, params0 = _lmtiny()
    opt = make_optimizer(OptimizerConfig(name="adamw", lr=3e-3))
    pods = _pods(params0)
    state = opt.init(pods)
    donating = ttrain.make_pod_step(cfg, opt)
    functional = ttrain.make_pod_step(cfg, opt, donate=False)
    d_pods, d_state = _clone(pods), _clone(state)
    for b in _batches(cfg.vocab_size, 3, (PODS, 4, 32)):
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        args = (d_pods, d_state, b)
        (d_pods2, d_state2, d_loss), rep = _held(donating, args, (0, 1))
        assert rep.ok, rep.violations
        assert d_pods2 is d_pods and d_state2 is d_state
        (pods, state, loss), rep = _held(functional, (pods, state, b), (0,))
        assert [v.cls for v in rep.violations] == ["dropped-donation"]
        assert torch.equal(d_loss, loss)
        assert _equal(d_pods, pods) and _equal(d_state, state)
    assert d_state["step"] == 3


def test_single_step_donates_bitwise_its_functional_twin():
    _, cfg, params0 = _lmtiny()
    opt = make_optimizer(OptimizerConfig(name="adamw", lr=3e-3))
    params = bridge.from_numpy(params0, CPU)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    donated = _clone(state)
    step, twin = (ttrain.make_single_step(cfg, opt),
                  ttrain.make_single_step(cfg, opt, donate=False))
    for b in _batches(cfg.vocab_size, 3, (4, 32)):
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        leaves = tree_leaves(donated)
        (got, loss), rep = _held(step, (donated, b), (0,))
        assert rep.ok and got is donated
        assert all(x is y for x, y in zip(tree_leaves(got), leaves)
                   if isinstance(y, torch.Tensor))
        state, want = twin(state, b)
        assert torch.equal(loss, want) and _equal(donated, state)
    assert donated["step"] == 3


def test_pod_step_matches_reference_pod_step():
    """Two donating pod steps against the reference's ``pod_step``
    (``train.py:226-235``: vmapped value_and_grad + the optimizer, jitted
    with ``donate_argnums=(0, 1)``) from one init and batches, with SGD
    at lr 0.1, whose step is linear in the gradient: the losses at the LM
    parity's rtol 1e-5 (``tests/test_torch_model.py``), and the first
    step's update ``p0 - p1`` (lr x the gradient) within 1e-4 of the
    leaf's largest update plus the fp32 rounding of the two stored
    weights, an ulp of ``p0`` a side.  (The model test holds one
    sequence pair's gradients to 3e-5 of the leaf's largest; at 4 x 32
    tokens a pod the output projection's, summed over more tokens, agree
    to 4.5e-5 of it, measured.)  AdamW's
    own arithmetic is held to the reference's in
    ``test_torch_model.py::test_adamw_step_matches_reference``: at a
    first step it moves a weight by lr x g / (|g| + eps), which turns a
    gradient at the floor of the two frameworks' agreement into a step
    of either sign."""
    jcfg, cfg, params0 = _lmtiny()
    kw = dict(name="sgd", lr=0.1)
    jopt = jmake_optimizer(JOptimizerConfig(**kw))

    def one(p, o, batch):
        loss, g = jax.value_and_grad(lambda q: jlm_loss(q, batch, jcfg))(p)
        p, o = jopt.apply(p, g, o)
        return p, o, loss

    jstep = jax.jit(jax.vmap(one), donate_argnums=(0, 1))
    jpods = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (PODS,) + a.shape).copy(),
        params0)
    opt = make_optimizer(OptimizerConfig(**kw))
    tp = _pods(params0)
    jp, js, ts = jpods, jax.vmap(jopt.init)(jpods), opt.init(tp)
    step = ttrain.make_pod_step(cfg, opt)
    p0 = [np.array(x) for x in jax.tree.leaves(jpods)]  # jpods is donated
    for i, b in enumerate(_batches(cfg.vocab_size, 2, (PODS, 4, 32))):
        jp, js, jl = jstep(jp, js, {k: jnp.asarray(v, jnp.int32)
                                    for k, v in b.items()})
        tp, ts, tl = step(tp, ts, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        np.testing.assert_allclose(_n(tl), np.asarray(jl), rtol=1e-5)
        if i:
            continue
        for a, b, p in zip(tree_leaves(tp), jax.tree.leaves(jp), p0):
            want = p - np.asarray(b)
            gap = np.abs((p - _n(a)) - want)
            tol = 1e-4 * np.abs(want).max() + 2 * np.spacing(np.abs(p))
            assert np.all(gap <= tol), float((gap - tol).max())


# ---------------------------------------------------------------------------
# the async commit (the toy round tree)
# ---------------------------------------------------------------------------

def _toy(seed, n=PODS):
    rng = np.random.default_rng(seed)
    wg = {k: rng.normal(size=s).astype(np.float32)
          for k, s in SHAPES.items()}
    pods = {k: (g[None] + 0.01 * rng.normal(size=(n,) + g.shape))
            .astype(np.float32) for k, g in wg.items()}
    return wg, pods


def _hcfg(mode, n_clusters=1, module=HermesConfig):
    return module(alpha=-0.5, beta=0.1, lam=2, window=4, compression=mode,
                  error_feedback=mode in ("int8", "int4"),
                  n_clusters=n_clusters)


@pytest.fixture
def open_gates(monkeypatch):
    """Every GUP gate open, on both sides."""
    monkeypatch.setattr(jhs, "gup_gate_jax",
                        lambda s, x, cfg: (jnp.asarray(True), s))
    monkeypatch.setattr(ths, "gup_gate",
                        lambda s, x, cfg: (torch.ones(x.shape[0],
                                                      dtype=torch.bool), s))


CASES = [("none", 1, 3), ("int8", 1, 3), ("int4", 1, 3), ("int8", 2, 4),
         ("int4", 2, 4)]


@pytest.mark.parametrize("mode,clusters,n", CASES)
def test_commit_donates_bitwise_and_matches_reference(open_gates, mode,
                                                      clusters, n):
    """``make_async_round_fns``' commit: every pod row bitwise the bare
    functional commit's on the same pending, written into the donated
    leaves, ``pending`` emptied; both against the reference's
    ``commit_jit`` (``make_async_round_jits``) within 8 fp32 ulps of the
    largest term an element sums (``tests/test_torch_cluster.py``'s
    tolerance).  int4's dither is the reference's draw on both sides."""
    wg, pods = _toy(3, n)
    tcfg, jcfg = _hcfg(mode, clusters), _hcfg(mode, clusters, JHermesConfig)
    losses = np.linspace(0.8, 1.4, n).astype(np.float32)
    L = np.float32(1.2)
    # copies: from_numpy shares the array, and the commit writes its pods
    t = lambda tree: tree_map(  # noqa: E731
        lambda a: torch.from_numpy(a.copy()), tree)
    dispatch, commit = ttrain.make_async_round_fns(tcfg)
    tgup = ths.hermes_pod_state(tcfg, n, CPU)
    dp = dispatch(t(pods), tgup, torch.from_numpy(losses), t(wg),
                  torch.tensor(L), None, round_step=2, noise=jax_noise(5))
    pending = dp["pending"]
    assert ths.pending_merges(pending)
    donated = t(pods)
    leaves = tree_leaves(donated)
    want = ths.hermes_cluster_commit(t(pods), dict(pending), t(wg), cfg=tcfg)
    got, rep = _held(commit, (donated, pending, t(wg)), (0,))
    assert rep.ok, rep.violations
    assert pending == {}
    assert all(x is y for x, y in zip(tree_leaves(got["pod_params"]),
                                      leaves))
    assert _equal(got["pod_params"], want["pod_params"])
    assert _equal(got["w_global"], want["w_global"])
    assert torch.equal(got["gates"], want["gates"])

    jd, jc = jtrain.make_async_round_jits(jcfg)
    jpods = jax.tree.map(jnp.asarray, pods)
    jdp = jd(jpods, jhs.hermes_pod_state(jcfg, n), jnp.asarray(losses),
             jax.tree.map(jnp.asarray, wg), jnp.asarray(L), None,
             jax.random.fold_in(jax.random.PRNGKey(5), 2))
    jcm = jc(jax.tree.map(jnp.asarray, pods), jdp["pending"],
             jax.tree.map(jnp.asarray, wg))
    for key in ("w_global", "pod_params"):
        for gt, wt, g, p in zip(tree_leaves(got[key]),
                                jax.tree.leaves(jcm[key]),
                                jax.tree.leaves(wg), jax.tree.leaves(pods)):
            scale = np.abs(g) + np.max(np.abs(p), axis=0)
            gap = np.abs(_n(gt) - np.asarray(wt))
            assert np.all(gap <= 8 * EPS32 * (scale + 1.0)), \
                (key, float(gap.max()))


def test_train_hermes_async_runs_the_donating_halves(monkeypatch):
    """``train_hermes`` takes its commit from ``make_async_round_fns`` (one
    definition, as the reference's), and that commit donates."""
    seen = []
    real = ttrain.make_async_round_fns

    def spy(hcfg, groups=None):
        dispatch, commit = real(hcfg, groups)

        def traced(pods, pending, wg):
            before = [x.untyped_storage().data_ptr()
                      for x in tree_leaves(pods)]
            out = commit(pods, pending, wg)
            seen.append((pending == {}, before == [
                x.untyped_storage().data_ptr()
                for x in tree_leaves(out["pod_params"])]))
            return out

        return dispatch, traced

    monkeypatch.setattr(ttrain, "make_async_round_fns", spy)
    out = ttrain.train_hermes(
        ttrain._preset("lmtiny"), steps=6, batch=2, seq=16, pods=2,
        opt_cfg=OptimizerConfig(name="adamw", lr=3e-3),
        hcfg=HermesConfig(alpha=-0.8, lam=2, compression="int8",
                          async_rounds=True), log_every=10 ** 6,
        device="cpu")
    assert out["drained"] and len(seen) == out["rounds"]
    assert all(cleared and kept for cleared, kept in seen)
