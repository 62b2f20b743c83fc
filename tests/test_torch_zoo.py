"""The model zoo of the port (``repro_torch.configs``, ``models.lm``)
against the JAX reference on the CPU: parameter counts at full size,
smoke-size trees and logits, decode against the full forward, and
``init_lm``'s stacks filled in place."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jsmoke
from repro.models import init_lm as jinit_lm
from repro.models import lm_forward as jlm_forward

from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.train import _preset
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import rwkv as R
from repro_torch.utils.trees import tree_map

CPU = torch.device("cpu")
NEW = ["qwen3-8b", "yi-6b", "phi3-mini-3.8b", "granite-34b", "grok-1-314b",
       "deepseek-v2-lite-16b"]
PORTED = NEW + ["rwkv6-3b", "recurrentgemma-2b", "seamless-m4t-large-v2",
                "llava-next-34b"]
# parameters of the published configs, counted from the reference's
# jax.eval_shape(init_lm) leaves
COUNTS = {"deepseek-v2-lite-16b": 16_210_324_992, "qwen3-8b": 8_190_735_360,
          "yi-6b": 6_061_035_520, "phi3-mini-3.8b": 3_821_079_552,
          "granite-34b": 33_963_454_464, "grok-1-314b": 316_489_340_928,
          "seamless-m4t-large-v2": 1_632_253_952,
          "llava-next-34b": 34_388_917_248}


def _paths(tree, prefix=""):
    """``{path: leaf}`` of nested dicts and lists."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _jshapes(jcfg):
    return jax.eval_shape(lambda: jinit_lm(jcfg, jax.random.PRNGKey(0))[0])


@pytest.mark.parametrize("arch", PORTED)
def test_param_count_matches_reference_tree(arch):
    """No allocation: the reference's tree by ``eval_shape``, the port's
    count from its config."""
    leaves = jax.tree.leaves(_jshapes(jget_config(arch)))
    want = sum(int(np.prod(s.shape)) for s in leaves)
    assert get_config(arch).param_count() == want
    if arch in COUNTS:
        assert want == COUNTS[arch]


@pytest.mark.parametrize("arch", PORTED)
def test_smoke_tree_matches_reference(arch):
    want = {k: tuple(v.shape) for k, v in _paths(_jshapes(jsmoke(arch)))
            .items()}
    tcfg = get_smoke_config(arch)
    got = {k: tuple(v.shape) for k, v in
           _paths(lm.init_lm(tcfg, 0, CPU)).items()}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == tcfg.param_count()


def _pair(arch, seed=1):
    jcfg = dataclasses.replace(jsmoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = jax.device_get(jinit_lm(jcfg, jax.random.PRNGKey(seed))[0])
    return jcfg, tcfg, jp, bridge.from_numpy(jp, CPU)


@pytest.mark.parametrize("arch", NEW)
def test_smoke_logits_match_reference(arch):
    """Full-forward logits from one init, in fp32 (both sides' attention
    "naive", MoE "auto": dense at these 24 tokens)."""
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 12))
    want = np.asarray(jlm_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                  impl="naive"))
    got = lm.lm_forward(tp, torch.from_numpy(toks), tcfg,
                        impl="naive").numpy()
    # fp32 through 2-3 blocks in other summation orders: 1e-5 of the
    # logits' largest magnitude (a few hundred ulps of it)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b",
                                  "granite-34b"])
@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_decode_matches_forward(arch, impl):
    """A 7-token prefill, then token-by-token decode, reproduces the full
    forward's logits (the reference's ``test_decode_matches_forward``, in
    fp32 with an fp32 cache)."""
    _, tcfg, _, tp = _pair(arch, 3)
    T, n = 12, 7
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, T)))
    full = lm.lm_forward(tp, toks, tcfg, impl="naive")
    cache = lm.init_cache(tcfg, 2, T + 2, dtype=torch.float32, device="cpu")
    lg, cache = lm.prefill_step(tp, cache, {"tokens": toks[:, :n]}, tcfg,
                                impl=impl)
    # fp32 in other orders: 1e-5 of the largest logit
    atol = 1e-5 * float(full.abs().max())
    torch.testing.assert_close(lg[:, -1], full[:, n - 1], rtol=0,
                               atol=atol)
    for t in range(n, T):
        lg, cache = lm.decode_step(tp, cache, toks[:, t:t + 1], t, tcfg,
                                   impl=impl)
        torch.testing.assert_close(lg[:, 0], full[:, t], rtol=0, atol=atol,
                                   msg=f"position {t}")


def _drawn_then_stacked(cfg, seed):
    """The init as drawn before the stacks were filled in place: every
    block drawn in turn, then ``torch.stack`` of each leaf."""
    gen = torch.Generator().manual_seed(seed)
    d = cfg.d_model
    blocks = []
    for _ in range(cfg.num_layers):
        p = {"norm1": L.init_norm(cfg, d, CPU),
             "norm2": L.init_norm(cfg, d, CPU)}
        if cfg.is_attention_free:
            p["mixer"] = R.init_time_mix(cfg, gen, CPU)
            p["mlp"] = R.init_channel_mix(cfg, gen, CPU)
        else:
            p["mixer"] = A.init_attention(cfg, gen, CPU)
            p["mlp"] = L.init_mlp(cfg, gen, CPU)
        blocks.append(p)
    emb = {"table": L.dense_init(gen, (cfg.vocab_size, d), CPU, scale=1.0)}
    if not cfg.tie_embeddings:
        emb["head"] = L.dense_init(gen, (d, cfg.vocab_size), CPU)
    return {"embedding": emb,
            "layers": tree_map(lambda *xs: torch.stack(xs), *blocks),
            "final_norm": L.init_norm(cfg, d, CPU)}


@pytest.mark.parametrize("preset", ["lmtiny", "rwkv6-3b"])
def test_init_lm_fills_stacks_bit_for_bit(preset):
    cfg = _preset(preset)
    want = _paths(_drawn_then_stacked(cfg, 7))
    got = _paths(lm.init_lm(cfg, 7, CPU))
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    half = _paths(lm.init_lm(cfg, 7, CPU, dtype=torch.bfloat16))
    for k in want:
        assert half[k].dtype == torch.bfloat16
        assert torch.equal(half[k], want[k].to(torch.bfloat16)), k
