"""The three merges on bf16 leaves, the port's plain versions against the
reference's Pallas kernels (interpret mode off-TPU), on the CPU.

Both widen ``g`` (and the fp32 merge's pods) to fp32, merge in fp32 and
round once to bf16 on the way out.  The port's plain versions round once
per operation, as its CUDA kernels do (they are held to them bitwise on
the card); XLA may contract ``acc + w2*p`` into one FMA in the Pallas
kernels' interpret mode (ROADMAP, "FMA contraction"), which moves the
fp32 sum by an ulp of fp32.  Rounded to bf16 that lands on the same
value, or, where the fp32 sum sits at a bf16 rounding boundary, on the
next one: so the bound is one bf16 ulp, counted on the bit patterns.
A closed round returns ``g`` exactly.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from repro.dist import wire as jwire
from repro.kernels import ops as jops

import torch_parity  # noqa: F401  (one torch thread)
import torch

from repro_torch.kernels import ops as tops

# a whole block, a short tail on the last axis, and a middle blocked axis
SHAPES = [(256,), (7, 130), (3, 5, 300)]


def _inputs(shape, n_pods, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=shape).astype(np.float32)
    delta = (0.1 * rng.normal(size=(n_pods,) + shape)).astype(np.float32)
    w2 = np.abs(rng.normal(size=n_pods)).astype(np.float32)
    denom = np.float32(0.7 + w2.sum(dtype=np.float32))
    return g, delta, w2, denom


def _bf16_bits(x) -> np.ndarray:
    """bf16 values as their 16-bit patterns, ordered so that neighbouring
    values differ by one (sign-magnitude folded)."""
    t = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(torch.bfloat16)
    b = t.view(torch.int16).to(torch.int32).numpy()
    return np.where(b < 0, -(b & 0x7FFF), b)


def _within_one_ulp(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.bfloat16
    a = _bf16_bits(got.to(torch.float32).numpy())
    b = _bf16_bits(np.asarray(jnp.asarray(want, jnp.float32)))
    assert np.abs(a - b).max() <= 1, np.abs(a - b).max()


def _t_bf16(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float32)).to(torch.bfloat16)


def _j_bf16(x):
    return jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_pods", [1, 3])
def test_bf16_dequant_merges_vs_pallas(fmt, shape, n_pods):
    g, delta, w2, denom = _inputs(shape, n_pods, len(shape) * 7 + n_pods)
    stacked = (n_pods,) + shape
    pay = jwire.get_format(fmt).encode(
        jnp.asarray(delta), **({"rng": jax.random.PRNGKey(3)}
                               if fmt == "int4" else {}))
    ax = jwire.block_axis(stacked)
    key = "q" if fmt == "int8" else "q_packed"
    port = tops.dequant_merge if fmt == "int8" else tops.dequant_merge_packed
    ref = jops.dequant_merge if fmt == "int8" else jops.dequant_merge_packed
    for push in (True, False):
        got = port(_t_bf16(g), torch.as_tensor(np.array(pay[key])),
                   torch.as_tensor(np.array(pay["scales"])),
                   torch.as_tensor(w2), torch.tensor(denom),
                   torch.tensor(push), axis=ax)
        want = ref(_j_bf16(g), pay[key], pay["scales"], jnp.asarray(w2),
                   jnp.asarray(denom), jnp.asarray(push), axis=ax)
        assert want.dtype == jnp.bfloat16
        _within_one_ulp(got, want)
        if not push:
            assert torch.equal(got, _t_bf16(g))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_pods", [1, 3])
def test_bf16_loss_weighted_update_vs_pallas(shape, n_pods):
    g, delta, w2, denom = _inputs(shape, n_pods, 11 * len(shape) + n_pods)
    pods = g[None] + delta
    w1 = np.float32(0.7)
    for push in (True, False):
        got = tops.loss_weighted_update(
            _t_bf16(g), _t_bf16(pods), torch.tensor(w1), torch.as_tensor(w2),
            torch.tensor(denom), torch.tensor(push))
        want = jops.loss_weighted_update(
            _j_bf16(g), _j_bf16(pods), jnp.asarray(w1), jnp.asarray(w2),
            jnp.asarray(denom), jnp.asarray(push))
        assert want.dtype == jnp.bfloat16
        _within_one_ulp(got, want)
        if not push:
            assert torch.equal(got, _t_bf16(g))
