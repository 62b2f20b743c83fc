"""The port's RG-LRU against the JAX reference, on the CPU: the diagonal
recurrence (the RG-LRU kernel's plain version), the recurrent block at
``rg-smoke``, and the GeLU MLP.

Inputs come from numpy seeds and are handed to both sides; the reference's
Pallas RG-LRU kernel runs in interpret mode, as its own tests run it.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jsmoke
from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_chunked
from repro.models import layers as JL
from repro.models import rglru as JG
from repro.models.layers import split_tree

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.rglru_scan import rglru_plain
from repro_torch.models import layers as L
from repro_torch.models import rglru as G

CPU = torch.device("cpu")


def _lru_inputs(B, T, W, seed=0, state=True):
    """The reference kernel test's regime: a in (0.7, 1), b ~ 0.2 N(0, 1),
    h0 ~ 0.5 N(0, 1)."""
    rng = np.random.default_rng(seed)
    a = (0.3 / (1 + np.exp(-rng.normal(size=(B, T, W)))) + 0.7
         ).astype(np.float32)
    b = (0.2 * rng.normal(size=(B, T, W))).astype(np.float32)
    h0 = (0.5 * rng.normal(size=(B, W))).astype(np.float32) if state \
        else None
    return a, b, h0


@pytest.mark.parametrize("B,T,W,chunk,bw", [
    (1, 32, 16, 8, 16),
    (2, 45, 24, 16, 8),      # ragged in both T and W for the TPU tiles
    (1, 128, 64, 128, 64),
])
def test_rglru_plain_matches_reference(B, T, W, chunk, bw):
    a, b, h0 = _lru_inputs(B, T, W, seed=T)
    y, hT = ops.rglru(*(torch.from_numpy(x) for x in (a, b, h0)))
    assert y.dtype == hT.dtype == torch.float32
    assert y.shape == (B, T, W) and hT.shape == (B, W)
    y_ref, hT_ref = jref.rglru_ref(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(h0))
    y_pl, hT_pl = rglru_chunked(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(h0), chunk=chunk, block_w=bw,
                                interpret=True)
    # the reference's own kernel tolerance: fp32 steps, and the oracle's
    # compiled scan may contract a*h + b into one FMA
    for want, want_T in ((y_ref, hT_ref), (y_pl, hT_pl)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(hT.numpy(), np.asarray(want_T), atol=1e-5)


def test_rglru_plain_without_state_and_carried():
    """No h0 means zeros; two calls carrying hT equal one call, bit for
    bit (the same fp32 steps in the same order)."""
    a, b, _ = _lru_inputs(2, 30, 8, seed=1, state=False)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    y, hT = rglru_plain(a, b)
    y0, hT0 = rglru_plain(a, b, torch.zeros((2, 8)))
    assert torch.equal(y, y0) and torch.equal(hT, hT0)
    y1, h1 = rglru_plain(a[:, :11], b[:, :11])
    y2, h2 = rglru_plain(a[:, 11:], b[:, 11:], h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(h2, hT)


def _block_params(seed=0):
    """The reference's rg-smoke RG-LRU block with its zero biases replaced
    by small random ones, so they take part in the comparison."""
    jcfg, tcfg = jsmoke("recurrentgemma-2b"), \
        get_smoke_config("recurrentgemma-2b")
    p = jax.device_get(split_tree(
        JG.init_rglru_block(jcfg, jax.random.PRNGKey(seed)))[0])
    rng = np.random.default_rng(seed)
    p = {k: (0.3 * rng.normal(size=np.shape(v))).astype(np.float32)
         if not np.asarray(v).any() else np.asarray(v) for k, v in p.items()}
    return jcfg, tcfg, p


def test_rglru_block_init_matches_reference():
    jcfg, tcfg = jsmoke("recurrentgemma-2b"), \
        get_smoke_config("recurrentgemma-2b")
    jp = jax.device_get(split_tree(
        JG.init_rglru_block(jcfg, jax.random.PRNGKey(0)))[0])
    tp = G.init_rglru_block(tcfg, torch.Generator().manual_seed(0), CPU)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tuple(tp[k].shape) == np.shape(jp[k]) and \
            tp[k].dtype == torch.float32
    # lam is deterministic: log(expm1(-log(linspace(0.9, 0.999)) / 8)),
    # computed in fp32 by numpy here and by XLA there
    np.testing.assert_allclose(tp["lam"].numpy(), jp["lam"], rtol=1e-5)


# fp32: the same operations in other summation orders.  bf16: each side
# rounds the block's projections, the conv's products and sums and the
# gate to bf16 (2^-8 relative) in its own order, and XLA may keep fused
# intermediates in fp32, so 2^-5 of the output's largest magnitude.
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2 ** -5, 2 ** -5)}


def _close(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.float()), want, rtol=rtol,
                               atol=atol * max(float(np.abs(want).max()), 1e-6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_matches_reference(dtype, with_state):
    """The block against the reference's ``seq`` path, and (stateless, T
    13) its ``assoc`` and ``chunked`` paths; with a state, the next ``h``
    and the carried conv tail too."""
    jcfg, tcfg, p = _block_params()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.default_rng(11)
    B, T, d, w = 2, 13, tcfg.d_model, tcfg.recurrent.lru_width
    x = (0.5 * rng.normal(size=(B, T, d))).astype(np.float32)
    jstate = tstate = None
    if with_state:
        h = (0.5 * rng.normal(size=(B, w))).astype(np.float32)
        conv = (0.5 * rng.normal(size=(B, 3, w))).astype(np.float32)
        jstate = {"h": jnp.asarray(h), "conv": jnp.asarray(conv).astype(jdt)}
        tstate = {"h": torch.from_numpy(h),
                  "conv": torch.from_numpy(conv).to(tdt)}
    jx = jnp.asarray(x).astype(jdt)
    wants = [JG.apply_rglru_block(p, jx, jcfg, None, state=jstate,
                                  impl=impl) for impl in
             (("seq",) if with_state else ("seq", "assoc", "chunked"))]
    tp = bridge.from_numpy(p, CPU)
    for impl in ("seq", "kernel"):
        out, st = G.apply_rglru_block(tp, torch.from_numpy(x).to(tdt), tcfg,
                                      state=tstate, impl=impl)
        assert out.dtype == tdt and out.shape == (B, T, d)
        for jo, js in wants:
            _close(out, jo, dtype)
        if with_state:
            js = wants[0][1]
            assert st["h"].dtype == torch.float32
            _close(st["h"], js["h"], dtype)
            # the tail is the block's last 3 conv inputs: the same bf16
            # projections on both sides, within the projection's rounding
            _close(st["conv"], js["conv"], dtype)
        else:
            assert st is None


def test_rglru_block_token_by_token_equals_one_pass():
    """A prompt in one stateful call, then token by token from its state,
    equals one pass over everything (the conv tail and h carried)."""
    _, tcfg, p = _block_params(seed=3)
    tp = bridge.from_numpy(p, CPU)
    rng = np.random.default_rng(4)
    x = torch.from_numpy((0.5 * rng.normal(size=(2, 12, tcfg.d_model))
                          ).astype(np.float32))
    full, _ = G.apply_rglru_block(tp, x, tcfg, impl="seq")
    state = G.init_rglru_state(tcfg, 2, torch.float32, "cpu")
    outs = []
    first, state = G.apply_rglru_block(tp, x[:, :5], tcfg, state=state,
                                       impl="kernel")
    outs.append(first)
    for t in range(5, 12):
        o, state = G.apply_rglru_block(tp, x[:, t:t + 1], tcfg, state=state,
                                       impl="kernel")
        outs.append(o)
    # fp32; the projections are batched per call instead of per sequence
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=1e-5,
                               atol=1e-5)
    # the carried conv tail is the last 3 tokens' input projections
    torch.testing.assert_close(
        state["conv"], torch.einsum("btd,dw->btw", x[:, -3:], tp["w_in_x"]),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    jcfg = jsmoke("recurrentgemma-2b")
    tcfg = get_smoke_config("recurrentgemma-2b")
    jp = jax.device_get(split_tree(JL.init_mlp(jcfg, jax.random.PRNGKey(1)))
                        [0])
    tp = L.init_mlp(tcfg, torch.Generator().manual_seed(1), CPU)
    assert sorted(jp) == sorted(tp) == ["wi", "wo"]
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(2, 9, tcfg.d_model))).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = JL.apply_mlp(jp, jnp.asarray(x).astype(jdt), jcfg, None)
    tp = bridge.from_numpy(jp, CPU)
    got = L.apply_mlp(tp, torch.from_numpy(x).to(tdt), "gelu")
    assert got.dtype == tdt
    _close(got, want, dtype)
    # the tanh form, not the erf form: they differ by ~1e-3 at |x| ~ 2
    erf = torch.nn.functional.gelu(torch.from_numpy(x) @ tp["wi"]) @ tp["wo"]
    if dtype == "float32":
        assert float((erf - got).abs().max()) > 1e-5


def test_recurrentgemma_configs_match_reference():
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config
    for jc, tc in ((jget_config("recurrentgemma-2b"),
                    get_config("recurrentgemma-2b")),
                   (jsmoke("recurrentgemma-2b"),
                    get_smoke_config("recurrentgemma-2b"))):
        for f in dataclasses.fields(tc):
            if f.name != "recurrent":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert dataclasses.asdict(tc.recurrent) == \
            dataclasses.asdict(jc.recurrent)


def test_rglru_impl_names():
    """One name per path: the block takes the reference's ``seq`` and
    ``kernel``; the stack's ``rec_impl`` takes ``scan`` and ``kernel`` for
    the RG-LRU as for WKV, and maps ``scan`` onto ``seq``."""
    from repro_torch.models.lm import apply_block, block_kind
    _, tcfg, p = _block_params(seed=5)
    tp = bridge.from_numpy(p, CPU)
    x = torch.zeros((1, 3, tcfg.d_model))
    with pytest.raises(ValueError, match="seq"):
        G.apply_rglru_block(tp, x, tcfg, impl="scan")
    layer = {"norm1": L.init_norm(tcfg, tcfg.d_model, CPU), "mixer": tp,
             "norm2": L.init_norm(tcfg, tcfg.d_model, CPU),
             "mlp": L.init_mlp(tcfg, torch.Generator().manual_seed(0), CPU)}
    assert block_kind(tcfg, 0) == "rec"
    outs = [apply_block(layer, x + 0.1, tcfg, kind="rec",
                        positions=torch.arange(3), rec_impl=r)[0]
            for r in ("scan", "kernel")]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="scan"):
        apply_block(layer, x, tcfg, kind="rec", positions=torch.arange(3),
                    rec_impl="seq")
